"""Seeded synthetic MNIST idx files, written by the port.

    python -m deep_vision_tpu_torch.tools.synth_mnist DIR [--train 6000]
        [--test 1000] [--seed 0]

writes the four files the `mnist` dataset kind reads under `--data-dir`
(`train-images-idx3-ubyte`, `train-labels-idx1-ubyte`,
`t10k-images-idx3-ubyte`, `t10k-labels-idx1-ubyte`) in the idx format:
a big-endian header (two zero bytes, the type code 0x08 for uint8, the
number of dimensions, then each dimension as a uint32) and the raw
bytes. Each image is 28 x 28 uint8 noise from
`numpy.random.default_rng(seed)` (the test split from seed + 1) with a
bright 7 x 7 square at a place set by its label (0-9), so a model can
learn the labels.
"""
from __future__ import annotations

import argparse
import os
import struct
from typing import Dict

import numpy as np

SIZE, PATCH, NUM_CLASSES = 28, 7, 10
FILES = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
         "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}


def write_idx(path: str, array: np.ndarray) -> None:
    """A uint8 array as an idx file."""
    array = np.ascontiguousarray(array, np.uint8)
    header = struct.pack(f">BBBB{array.ndim}I", 0, 0, 0x08, array.ndim,
                         *array.shape)
    with open(path, "wb") as f:
        f.write(header + array.tobytes())


def synth_digits(count: int, seed: int):
    """(images (count, 28, 28) uint8, labels (count,) uint8)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 128, (count, SIZE, SIZE), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES, count).astype(np.uint8)
    for i, label in enumerate(labels):
        r, c = divmod(int(label), 4)
        images[i, 1 + 6 * r:1 + 6 * r + PATCH,
               1 + 6 * c:1 + 6 * c + PATCH] = 255
    return images, labels


def write_synth_mnist(directory: str, train: int = 6000, test: int = 1000,
                      seed: int = 0) -> Dict[str, str]:
    """Write the four files; returns {file name: path}."""
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for split, count, s in (("train", train, seed), ("test", test, seed + 1)):
        images, labels = synth_digits(count, s)
        for name, array in zip(FILES[split], (images, labels)):
            paths[name] = os.path.join(directory, name)
            write_idx(paths[name], array)
    return paths


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("directory")
    parser.add_argument("--train", type=int, default=6000)
    parser.add_argument("--test", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    write_synth_mnist(args.directory, args.train, args.test, args.seed)
    print(f"wrote {args.train} + {args.test} idx images and labels under "
          f"{args.directory}")


if __name__ == "__main__":
    main()
