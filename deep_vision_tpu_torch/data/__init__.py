"""Data layer: record IO, dataset readers, host-side transforms, device feed.

The port of deep_vision_tpu/data/, module for module, minus `service`
(the dataset service over sockets, which comes with the multi-host
slice). Every module but `native` is plain Python and numpy, and none
imports torch, so spawned data workers start quickly:

- `records` / `example_codec`: TFRecord-compatible container +
  tf.train.Example wire codec, byte-identical to the reference's; the
  masked crc32c and the fast reader come from `native` (native/*.cc,
  built with g++ at first use by `native_build`); strict readers raise
  on corruption, `read_records_tolerant` + `BadRecordBudget` skip and
  dead-letter it under a bound;
- `datasets`: MNIST idx, ImageNet folder, and record-backed datasets with
  the reference's Example schemas (ImageNet, VOC/COCO boxes, MPII joints)
  or a callable schema;
- `transforms` / `labels`: the numpy augmentation set (with SpaceToDepth
  for the s2d stem) and the dense-prediction label generators;
- `pipeline`: threaded or spawned-process decode/augment workers -> a
  shuffle buffer -> fixed-shape numpy batches, with host prefetch;
- `snapshot`: the loader's resumable position (`DataLoader.state_dict`);
- `device_prefetch`: `DevicePrefetcher`, which places the next batches
  on the card on a producer thread (the Trainer's `device_prefetch`).
"""
from deep_vision_tpu_torch.data.example_codec import (
    decode_example,
    encode_example,
)
from deep_vision_tpu_torch.data.records import (
    BadRecordBudget,
    BadRecordBudgetExceeded,
    RecordWriter,
    read_records,
    read_records_tolerant,
    record_iterator,
    write_records,
)
from deep_vision_tpu_torch.data.datasets import (
    ImageFolderDataset,
    MnistDataset,
    RecordDataset,
)
from deep_vision_tpu_torch.data import transforms
from deep_vision_tpu_torch.data.pipeline import DataLoader, Compose
from deep_vision_tpu_torch.data.device_prefetch import (
    DevicePrefetcher,
    PlacedBatch,
)
from deep_vision_tpu_torch.data.snapshot import (
    DataLoaderState,
    SnapshotError,
    SnapshotMismatch,
    SnapshotUnsupported,
)

__all__ = [
    "DataLoaderState",
    "SnapshotError",
    "SnapshotMismatch",
    "SnapshotUnsupported",
    "DevicePrefetcher",
    "PlacedBatch",
    "BadRecordBudget",
    "BadRecordBudgetExceeded",
    "decode_example",
    "encode_example",
    "RecordWriter",
    "read_records",
    "read_records_tolerant",
    "record_iterator",
    "write_records",
    "ImageFolderDataset",
    "MnistDataset",
    "RecordDataset",
    "transforms",
    "DataLoader",
    "Compose",
]
