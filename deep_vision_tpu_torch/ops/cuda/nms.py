"""Greedy NMS selection: the CUDA kernels' wrapper and its plain version.

The port of `pallas_nms` (deep_vision_tpu/ops/pallas/nms.py:88-125); the
kernels are `csrc/nms.cu` (nms_compact, then the cooperative nms_select:
a sort, then an IoU bitmask and a chunked scan per pass of sorted
candidates, `pass_starts`), whose header says what they replace, why a
sorted scan is the same function and what bounds it.

`greedy_nms` routes by the tensors' device and nothing else: a CPU tensor
takes `nms_plain`, a CUDA tensor launches the kernels or raises. There is
no fallback from the kernels to the plain version. One call enqueues every
phase on the current stream with one ctypes call and no host
synchronisation; `greedy_nms.launches` counts such calls (a plain integer,
added to under a lock, since a serving pool's replicas launch from
threads of their own; set it to 0 to start a count).

Semantics, shared by both and by the reference: scores below
`score_threshold` become -1; each of the D rounds picks the largest live
score (first index on ties) and keeps it only if it is > 0; a kept pick
suppresses itself and every candidate with IoU >= `iou_threshold`.
Returns `(sel_scores (B, D) f32, sel_idx (B, D) int32)`, -1 = no pick.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from deep_vision_tpu_torch.ops.cuda import build

#: K, the most sorted candidates one pass's IoU bitmask covers (a
#: multiple of 64, at most the kernels' 4096): a K x K bit workspace per
#: image, 2 MB at 4096. Passes cover FIRST_PASS candidates, then twice
#: as many each time up to K, until D keeps or the last candidate.
PASS_CANDIDATES = 4096
FIRST_PASS = 512

_launches_lock = threading.Lock()

_SIGNATURES = {  # name: (restype, argtypes)
    "dvt_nms_workspace_bytes": (ctypes.c_longlong, [ctypes.c_int] * 3),
    "dvt_nms_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p]),
}


def _lib() -> ctypes.CDLL:
    lib = build.load("nms")
    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def pass_size(n: int, pass_candidates: int) -> int:
    """K for N candidates: `pass_candidates`, or N rounded up to 64 when
    that is smaller (the mask is K x K bits)."""
    return max(64, min(pass_candidates, -(-n // 64) * 64))


def pass_starts(n: int, pass_candidates: int) -> list:
    """[(first sorted position, size)] of the passes the kernels may run
    over N candidates: FIRST_PASS, then doubling up to K."""
    k = pass_size(n, pass_candidates)
    size, base, passes = min(FIRST_PASS, k), 0, []
    while base < n:
        passes.append((base, size))
        base, size = base + size, min(2 * size, k)
    return passes


def selection_plan(scores: torch.Tensor, sel_idx: torch.Tensor,
                   score_threshold: float, pass_candidates: int
                   ) -> Tuple[list, list, list]:
    """(M, passes, chunks) per image, for the record, from the inputs and
    the selection alone: M = the candidates (score >= threshold and > 0);
    passes and chunks = the passes (`pass_starts`) and 64-candidate chunks
    the scan walks, up to the D-th keep or the last candidate."""
    n = scores.shape[1]
    passes = pass_starts(n, pass_candidates)
    d = sel_idx.shape[1]
    thr = torch.tensor(score_threshold, dtype=torch.float32,
                       device=scores.device)
    idx = torch.arange(n, device=scores.device)
    plan = ([], [], [])
    for s, sel in zip(scores, sel_idx):
        cand = (s >= thr) & (s > 0.0)
        m = int(cand.sum())
        kept = sel[sel >= 0].long()
        if d and len(kept) == d:  # stopped at the D-th keep: its rank
            last = kept[-1]
            rank = int((cand & ((s > s[last]) | ((s == s[last])
                                                 & (idx < last)))).sum())
        else:  # walked every candidate
            rank = m - 1
        walked = (sum(base <= rank for base, _ in passes), rank // 64 + 1)
        for part, v in zip(plan, (m,) + walked):
            part.append(v)
    return plan


def _check(boxes: torch.Tensor, scores: torch.Tensor,
           max_detections: int) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, N, 4), got {tuple(boxes.shape)}")
    if tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"scores {tuple(scores.shape)} do not match boxes "
                         f"{tuple(boxes.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got "
                        f"{boxes.dtype} and {scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if max_detections < 0:
        raise ValueError(f"max_detections must be >= 0, got {max_detections}")


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, max_detections: int,
              iou_threshold: float, score_threshold: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same D rounds in plain PyTorch, vectorised over the batch, with
    the kernel's arithmetic (thresholds as float32, IoU in the same order).
    Runs every round: a round after the last keep changes nothing."""
    b, n, _ = boxes.shape
    d, dev = int(max_detections), boxes.device
    out_s = torch.zeros((b, d), dtype=torch.float32, device=dev)
    out_i = torch.full((b, d), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return out_s, out_i
    iou_thr = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    score_thr = torch.tensor(score_threshold, dtype=torch.float32, device=dev)
    live = torch.where(scores >= score_thr, scores,
                       torch.tensor(-1.0, device=dev))
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    idx = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    for i in range(d):
        best = live.max(dim=1).values
        bi = torch.where(live == best[:, None], idx, n).min(dim=1).values
        keep = best > 0.0
        out_s[:, i] = torch.where(keep, best, 0.0)
        out_i[:, i] = torch.where(keep, bi, -1).to(torch.int32)
        bx1, by1, bx2, by2 = (c[rows, bi][:, None] for c in (x1, y1, x2, y2))
        iw = (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp(min=0.0)
        ih = (torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp(min=0.0)
        inter = iw * ih
        union = area + area[rows, bi][:, None] - inter
        iou = inter / union.clamp(min=1e-9)
        suppress = (iou >= iou_thr) | (idx == bi[:, None])
        live = torch.where(keep[:, None] & suppress, -1.0, live)
    return out_s, out_i


def _launch(boxes: torch.Tensor, scores: torch.Tensor, d: int,
            iou_threshold: float, score_threshold: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("the NMS kernel takes contiguous boxes and scores")
    if boxes.data_ptr() % 16:
        raise ValueError("the NMS kernel reads boxes as float4: their data "
                         "must be 16-byte aligned")
    lib = _lib()
    b, n, _ = boxes.shape
    dev = boxes.device
    out_s = torch.empty((b, d), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, d), dtype=torch.int32, device=dev)
    if b == 0 or d == 0:
        return out_s, out_i  # nothing to select: no launch
    k = pass_size(n, PASS_CANDIDATES)
    # uninitialised: every phase writes what a later one reads
    workspace = torch.empty(lib.dvt_nms_workspace_bytes(b, n, k),
                            dtype=torch.uint8, device=dev)
    err = lib.dvt_nms_launch(
        boxes.data_ptr(), scores.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), workspace.data_ptr(), b, n, d,
        min(FIRST_PASS, k), k, iou_threshold, score_threshold, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError_t {err}")
    with _launches_lock:
        greedy_nms.launches += 1
    return out_s, out_i


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_detections: int,
               iou_threshold: float, score_threshold: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS selection over boxes (B, N, 4) xyxy float32 and
    scores (B, N) float32. CPU tensors: `nms_plain`; CUDA tensors: the
    kernel."""
    _check(boxes, scores, max_detections)
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, max_detections, iou_threshold,
                         score_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_nms runs on cpu or cuda, not {boxes.device}")
    return _launch(boxes, scores, int(max_detections), float(iou_threshold),
                   float(score_threshold))


greedy_nms.launches = 0
