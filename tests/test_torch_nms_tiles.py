"""A CPU model of the Hopper NMS kernels, held against the plain version
and the JAX Pallas kernel.

`csrc/nms.cu` cannot run here. This file models its phases in PyTorch and
numpy, with the kernels' constants and rules, so the design is rehearsed
on the CPU before it runs on the card:

- nms_compact: the candidates {j : s_j >= score_threshold and s_j > 0}
  in index order (NaN scores fail both tests);
- the sort: each candidate's rank = the number of candidates that beat it
  (larger score, or an equal score and a lower index); the model checks
  that this equals a stable sort on the scores' uint32 bit patterns;
- per pass (512 sorted candidates, then twice as many each pass up to
  K): the mask's 64-bit words (bit t of word w of row i set when
  iou(box_{64w+t}, box_i) >= thr, i < 64w + t), and the pass's columns
  already suppressed by earlier passes' keeps; the scan's walk, 64
  candidates a chunk: the chunk's `removed` word = the earlier passes'
  bits | the words of the pass's kept rows for the chunk; then, over
  ~removed & valid, steps that keep every live row up to f, the first
  live row whose diagonal word hits a live later row, and clear f's
  word; a stop at D keeps.

IoU is the plain version's float32 arithmetic, min, max and the clips
propagating NaN. Every comparison is exact: the model must be bitwise
equal to `nms_plain`, and to `pallas_nms(interpret=True)` where the JAX
kernel's run time allows, over the shared edge cases
(`deep_vision_tpu_torch/tools/nms_cases.py`) and with a small K injected
so that several passes run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.ops.pallas.nms import pallas_nms
from deep_vision_tpu_torch.ops.cuda.nms import (
    nms_plain,
    pass_size,
    pass_starts,
    selection_plan,
)
from deep_vision_tpu_torch.tools.nms_cases import detections, edge_cases

WORD = 64
MAX_PASS = 4096  # csrc/nms.cu kMaxPass
CASES = edge_cases()


def suppress_matrix(cand, pick, thr):
    """[pick, cand]: iou(cand, pick) >= thr, the plain version's order."""
    x1, y1, x2, y2 = (cand[None, :, k] for k in range(4))
    bx1, by1, bx2, by2 = (pick[:, None, k] for k in range(4))
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    barea = (bx2 - bx1).clamp(min=0.0) * (by2 - by1).clamp(min=0.0)
    iw = (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp(min=0.0)
    ih = (torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp(min=0.0)
    inter = iw * ih
    iou = inter / (area + barea - inter).clamp(min=1e-9)
    return iou >= thr


def pack_words(bits):
    """(R, 64 W) bool -> (R, W) uint64, bit t of word w = column 64w + t."""
    r, c = bits.shape
    pad = np.zeros((r, -(-c // WORD) * WORD), bool)
    pad[:, :c] = bits
    return np.packbits(pad, axis=1, bitorder="little").view("<u8")


def pass_mask(box, thr, rows=512):
    """nms_mask's words for one pass: (kp, tiles) uint64, upper triangle
    only (i < j), built in blocks of rows."""
    kp = len(box)
    col = torch.arange(kp)
    words = []
    for r0 in range(0, kp, rows):
        sup = suppress_matrix(box, box[r0:r0 + rows], thr)
        upper = col[None, :] > torch.arange(r0, min(r0 + rows, kp))[:, None]
        words.append(pack_words((sup & upper).numpy()))
    return np.concatenate(words)


def compact(s, score_thr):
    cand = (s >= score_thr) & (s > 0.0)
    return torch.nonzero(cand).flatten()


def rank_order(s_c):
    """Counting sort: rank_i = #{j : s_j > s_i or (s_j == s_i, j < i)}."""
    m = len(s_c)
    pos = torch.arange(m)
    beats = (s_c[None, :] > s_c[:, None]) | (
        (s_c[None, :] == s_c[:, None]) & (pos[None, :] < pos[:, None]))
    rank = beats.sum(1)
    order = torch.empty(m, dtype=torch.long)
    order[rank] = pos
    # the same order as a stable sort on the positive floats' bit patterns
    bits = s_c.view(torch.int32).numpy().view(np.uint32).astype(np.int64)
    assert np.array_equal(np.argsort(-bits, kind="stable"), order.numpy())
    return order


def model_nms(boxes, scores, d, iou_thr, score_thr, k_pass, trace=None):
    """The kernels' phases for a batch; returns (sel_scores, sel_idx) and
    fills `trace` with (M, passes run, chunks scanned) per image."""
    b, n, _ = boxes.shape
    iou_thr = torch.tensor(iou_thr, dtype=torch.float32)
    score_thr = torch.tensor(score_thr, dtype=torch.float32)
    out_s = torch.zeros((b, d), dtype=torch.float32)
    out_i = torch.full((b, d), -1, dtype=torch.int32)
    for img in range(b):
        cand = compact(scores[img], score_thr)
        order = cand[rank_order(scores[img, cand])]
        m, keeps, passes, chunks = len(order), 0, 0, 0
        done = m == 0
        sorted_box = boxes[img, order]
        for base, k in pass_starts(n, k_pass):
            if done or base >= m:
                continue
            passes += 1
            kp = min(k, m - base)
            tiles = -(-kp // WORD)
            box = sorted_box[base:base + kp]
            mask = pass_mask(box, iou_thr)  # (kp, tiles)
            # columns already suppressed by the keeps of earlier passes
            kept_boxes = boxes[img, out_i[img, :keeps].long()]
            pre = pack_words(
                suppress_matrix(box, kept_boxes, iou_thr).any(0).numpy()
                [None, :])[0] if keeps else np.zeros(tiles, np.uint64)
            kept_rows = []  # this pass's keeps
            for c in range(tiles):
                if keeps >= d:
                    break
                chunks += 1
                removed = int(pre[c])
                for i in kept_rows:
                    removed |= int(mask[i, c])
                rows = min(WORD, kp - c * WORD)
                live = ((1 << rows) - 1) & ~removed
                diag = [int(mask[c * WORD + r, c]) if r < rows else 0
                        for r in range(WORD)]
                while live and keeps < d:
                    # every live row up to f, the first live row that
                    # suppresses a live later row, is kept in one step
                    conflict = sum(1 << r for r in range(WORD)
                                   if live >> r & 1 and diag[r] & live)
                    f = (conflict & -conflict).bit_length() - 1  # or -1
                    take = live if f < 0 else live & ((2 << f) - 1)
                    while bin(take).count("1") > d - keeps:
                        take &= ~(1 << (take.bit_length() - 1))
                    for t in range(WORD):
                        if take >> t & 1:
                            i = c * WORD + t
                            kept_rows.append(i)
                            out_s[img, keeps] = scores[img, order[base + i]]
                            out_i[img, keeps] = order[base + i]
                            keeps += 1
                    live &= ~take
                    if f >= 0 and take >> f & 1:
                        live &= ~diag[f]
            done = keeps >= d or base + kp >= m
        if trace is not None:
            trace.append((m, passes, chunks))
    return out_s, out_i


def assert_bitwise(got, want, label):
    for g, w, name in zip(got, want, ("scores", "indices")):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label}: {name}"
        assert g.tobytes() == w.tobytes(), f"{label}: {name}\n{g}\n{w}"


@pytest.mark.parametrize("k_pass", [MAX_PASS, 128, 64])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_model_matches_plain_bitwise(case, k_pass):
    label, boxes, scores, d, iou, thr = CASES[case]
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    trace = []
    got = model_nms(boxes, scores, d, iou, thr, k_pass, trace)
    want = nms_plain(boxes, scores, d, iou, thr)
    assert_bitwise(got, want, label)
    # the record's plan (M, passes, chunks) is what the model walked
    assert list(zip(*selection_plan(scores, want[1], thr, k_pass))) == trace


@pytest.mark.parametrize("case", [c for c in range(len(CASES))
                                  if CASES[c][1].shape[1] <= 300],
                         ids=[c[0] for c in CASES if c[1].shape[1] <= 300])
def test_model_matches_pallas_interpret(case):
    label, boxes, scores, d, iou, thr = CASES[case]
    want = pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), d, iou, thr,
                      interpret=True)
    got = model_nms(torch.from_numpy(boxes), torch.from_numpy(scores), d,
                    iou, thr, 128)
    assert_bitwise(got, [np.asarray(w) for w in want], label)


@pytest.mark.parametrize("k_pass", [64, 192])
def test_several_passes_with_cross_pass_suppression(k_pass):
    # D keeps are reached only after several passes, and every pass after
    # the first starts with columns that earlier passes' keeps suppress
    label, boxes, scores, d, iou, thr = CASES[-1]
    assert label.startswith("900 boxes in 30 clusters")
    trace = []
    got = model_nms(torch.from_numpy(boxes), torch.from_numpy(scores), d,
                    iou, thr, k_pass, trace)
    want = nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), d,
                     iou, thr)
    assert_bitwise(got, want, f"K={k_pass}")
    assert all(passes >= 3 for _, passes, _ in trace), trace
    assert (want[1] >= 0).sum(1).tolist() == [d, d]  # a stop at D


def test_yolo_scale():
    boxes, scores = detections(12, 1, 10_647)
    trace = []
    got = model_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 100,
                    0.5, 0.5, MAX_PASS, trace)
    want = nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), 100,
                     0.5, 0.5)
    assert_bitwise(got, want, "N=10647")
    m, passes, chunks = trace[0]
    assert m > MAX_PASS and passes == 1  # D keeps inside the first pass
    assert chunks < m // 64


def test_nan_rule_of_min_max_and_clip():
    # the plain version's minimum, maximum and clamp propagate NaN, so a
    # pick with a NaN coordinate gets IoU NaN and suppresses nothing; the
    # NaN-dropping fmin/fmax (C's fminf) would clip it to 0.5 x 0.5
    pick = torch.tensor([[np.nan, 0.0, 0.5, 0.5]])
    cand = torch.tensor([[0.0, 0.0, 0.5, 0.5]])
    thr = torch.tensor(0.5)
    assert not suppress_matrix(cand, pick, thr).any()
    iw = (torch.fmin(cand[:, 2], pick[:, 2])
          - torch.fmax(cand[:, 0], pick[:, 0])).clamp(min=0.0)
    assert iw.item() == 0.5
    s, i = nms_plain(torch.cat([pick, cand])[None],
                     torch.tensor([[0.9, 0.8]]), 5, 0.5, 0.5)
    assert i[0, :2].tolist() == [0, 1]


def test_pass_size_and_plan():
    assert pass_size(10_647, MAX_PASS) == 4096
    assert pass_size(77, MAX_PASS) == 128 and pass_size(0, 4096) == 64
    assert pass_size(1001, 64) == 64
    assert pass_starts(10_647, MAX_PASS) == [
        (0, 512), (512, 1024), (1536, 2048), (3584, 4096), (7680, 4096)]
    assert pass_starts(200, 64) == [(0, 64), (64, 64), (128, 64),
                                    (192, 64)]
    assert pass_starts(77, MAX_PASS) == [(0, 128)] and pass_starts(0, 64) == []
    scores = torch.tensor([[0.9, np.nan, 0.2, 0.0, 0.6, -1.0]])
    sel = torch.tensor([[0, 4, -1]], dtype=torch.int32)
    assert selection_plan(scores, sel, 0.0, 64) == ([3], [1], [1])
    # stopped at the D-th keep: its rank decides the pass
    sel = torch.tensor([[0, 4]], dtype=torch.int32)
    assert selection_plan(scores, sel, 0.0, 64) == ([3], [1], [1])
    scores = torch.rand(1, 300) + 0.1
    sel = torch.full((1, 3), -1, dtype=torch.int32)  # D not reached
    assert selection_plan(scores, sel, 0.0, 128) == ([300], [3], [5])
