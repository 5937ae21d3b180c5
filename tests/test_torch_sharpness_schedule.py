"""K5's block and thread schedule (csrc/sharpness.cu) emulated in torch on
the CPU: the items of ``box_spans`` (STRIP_COLS columns by ``seg_rows``
rows, for a grid of a given number of warps), whether a strip needs column
masks,
the lanes' LANE_COLS columns, the loads the kernel makes (rows past an
item only where the box goes on, a lane's own columns only where one is in
the box, the strip's edge columns only where the stencil needs them), the
neighbour columns from the next lanes, the sliding window of row triples,
the float32 sums of a column, the warps' float64 shuffle sums and the last
warp's sum of a box's partials in item order.  Each pixel of each box must
be visited exactly once, and the sums must equal ``sharpness_sums_plain``
within 1e-5 relative.  The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk

F32 = torch.float32


def box_spans(boxes, h: int, w: int, row_offset: int, vec: bool):
    """csrc/sharpness.cu's split of each (image, slot) box: an int64 array
    (B, 10, 6) of (y0, y1, x0, x1, xs, strips), the box's local rows
    [y0, y1) and columns [x0, x1) on the rows handed in and its strips of
    STRIP_COLS columns from xs (x0 rounded down to a multiple of LANE_COLS
    where ``vec``); all zero for a box that misses these rows."""
    bx = np.asarray(boxes, np.int64)
    y0 = np.maximum(bx[..., 0] - row_offset, 0)
    y1 = np.minimum(bx[..., 1] - row_offset, h)
    x0 = np.maximum(bx[..., 2], 0)
    x1 = np.minimum(bx[..., 3], w)
    hit = (y0 < y1) & (x0 < x1)
    xs = x0 // sk.LANE_COLS * sk.LANE_COLS if vec else x0
    strips = np.where(hit, -(-(x1 - xs) // sk.STRIP_COLS), 0)
    return np.stack([y0, y1, x0, x1, xs, strips], axis=-1) * hit[..., None]


def seg_rows(spans, warps: int) -> int:
    """The rows of the kernel's items for these spans on a grid of
    ``warps`` warps: the boxes' strip-rows over the warps, so that the
    items about match the warps, within [MIN_SEG_ROWS, MAX_SEG_ROWS]."""
    strip_rows = int((spans[..., 5] * (spans[..., 1] - spans[..., 0])).sum())
    return min(max(-(-strip_rows // warps), sk.MIN_SEG_ROWS), sk.MAX_SEG_ROWS)


def _warp_tree(x: torch.Tensor) -> torch.Tensor:
    """The shuffle-down sum of a warp over the last dim (32 lanes): lane l
    adds lane l + o for o = 16, 8, 4, 2, 1; lane 0's value."""
    x = x.clone()
    for o in (16, 8, 4, 2, 1):
        x[..., :o] = x[..., :o] + x[..., o:2 * o]
    return x[..., 0]


def emulate_sharpness_sums(pgm, boxes, halo=None, row_offset=0, vec=True,
                           warps=2640):
    """(s1, s2) as the kernel computes them on a grid of ``warps`` warps,
    and the visit count of every (image, slot, local row, column)."""
    b, h, w = pgm.shape
    bx = boxes.numpy()
    spans = box_spans(bx, h, w, row_offset, vec)
    item_rows = seg_rows(spans, warps)
    zero = torch.zeros(w, dtype=F32)
    sums = torch.zeros((b, 10, 2), dtype=torch.float64)
    visits = torch.zeros((b, 10, h, w), dtype=torch.int64)
    lanes = torch.arange(32)
    for i in range(b):
        def row(y):
            if 0 <= y < h:
                return pgm[i, y]
            if halo is not None and y in (-1, h):
                return halo[i, 0 if y == -1 else 1]
            return zero
        for k in range(10):
            y0, y1, x0, x1, xs, strips = (int(v) for v in spans[i, k])
            segs = -(-(y1 - y0) // item_rows)
            if not strips:
                continue
            top, bottom, left, right = (int(v) for v in bx[i, k])
            # columns (strips, 32 lanes, LANE_COLS), lane starts (strips, 32)
            xc = (xs + torch.arange(strips)[:, None] * sk.STRIP_COLS
                  + lanes[None] * sk.LANE_COLS)
            cols = xc[..., None] + torch.arange(sk.LANE_COLS)
            own = (xc < x1) & (xc + sk.LANE_COLS > x0)
            first = xc[:, 0]
            need_l = (first - 1 >= left) & (first - 1 >= 0)
            need_r = (first + sk.STRIP_COLS < right) & \
                (first + sk.STRIP_COLS < w)
            lf, rt = cols - 1 >= left, cols + 1 < right
            inside = (cols >= x0) & (cols < x1)
            cols_in = ((lf.to(F32) + 1.0) + rt.to(F32))
            # a strip the kernel walks without column masks must need none
            unmasked = (first - 1 >= left) & (first + sk.STRIP_COLS <= x1) \
                & (first + sk.STRIP_COLS < right)
            for st in torch.nonzero(unmasked).flatten().tolist():
                assert bool(lf[st].all() & rt[st].all() & inside[st].all())
            part = torch.zeros((segs, strips, 2), dtype=torch.float64)
            for seg in range(segs):
                r0 = y0 + seg * item_rows
                r1 = min(r0 + item_rows, y1)
                above = row_offset + r0 - 1 >= top
                last = r1 if row_offset + r1 < bottom else r1 - 1

                def load(y, loaded):
                    vals = row(y)
                    v = torch.where(own[..., None] & (cols < w) & loaded,
                                    vals[cols.clamp(0, w - 1)], 0.0)
                    el = torch.where(need_l & loaded,
                                     vals[(first - 1).clamp(0, w - 1)], 0.0)
                    er = torch.where(need_r & loaded, vals[
                        (first + sk.STRIP_COLS).clamp(0, w - 1)], 0.0)
                    # a lane's neighbours: the next lanes' columns, the
                    # strip's edge columns at lanes 0 and 31
                    flat = v.reshape(strips, -1)
                    lv = torch.cat([el[:, None], flat[:, :-1]], 1)
                    rv = torch.cat([flat[:, 1:], er[:, None]], 1)
                    lv, rv = lv.reshape(v.shape), rv.reshape(v.shape)
                    trip = (torch.where(lf, lv, 0.0) + v) + \
                        torch.where(rt, rv, 0.0)
                    return v, trip

                _, t_up = load(r0 - 1, above)
                mid, t_mid = load(r0, True)
                a1 = torch.zeros(cols.shape, dtype=F32)
                a2 = torch.zeros(cols.shape, dtype=F32)
                for y in range(r0, r1):
                    nxt, t_dn = load(y + 1, y + 1 <= last)
                    gy = row_offset + y
                    up, dn = gy - 1 >= top, gy + 1 < bottom
                    rows_in = (float(up) + 1.0) + float(dn)
                    box3 = ((t_up if up else torch.zeros_like(t_up)) + t_mid) \
                        + (t_dn if dn else torch.zeros_like(t_dn))
                    resp = 9.0 * mid - box3
                    wgt = 9.0 - rows_in * cols_in
                    a2 = torch.where(inside, a2 + resp * resp, a2)
                    a1 = torch.where(inside, a1 + mid * wgt, a1)
                    visits[i, k, y, cols[inside]] += 1
                    t_up, t_mid, mid = t_mid, t_dn, nxt
                for j, acc in enumerate((a1, a2)):
                    lane_sum = torch.zeros(acc.shape[:2], dtype=torch.float64)
                    for c in range(sk.LANE_COLS):
                        lane_sum = lane_sum + acc[..., c].double()
                    part[seg, :, j] = _warp_tree(lane_sum)
            # the last warp: lane l adds items l, l + 32, ... in item order
            flat = part.reshape(-1, 2)
            lane_acc = torch.zeros((32, 2), dtype=torch.float64)
            for item in range(flat.shape[0]):
                lane_acc[item % 32] = lane_acc[item % 32] + flat[item]
            sums[i, k] = _warp_tree(lane_acc.T)
    return sums[..., 0], sums[..., 1], visits


def _boxes(b, rows):
    boxes = torch.zeros((b, 10, 4), dtype=torch.int32)
    for i, per_image in enumerate(rows):
        for k, bx in enumerate(per_image):
            boxes[i, k] = torch.tensor(bx)
    return boxes


# name -> (B, H, W, boxes per image, row_offset, with a halo)
CASES = {
    "tile seams": (2, 100, 300, [
        [(31, 65, 127, 133), (30, 97, 3, 290)],
        [(0, 33, 125, 260), (63, 100, 1, 129)]], 0, False),
    "whole frame": (1, 97, 260, [[(0, 97, 0, 260)]], 0, False),
    "4 px": (1, 70, 256, [[(40, 44, 130, 134), (0, 4, 252, 256)]], 0, False),
    "10 boxes": (2, 90, 200, [
        [(y, y + 20 + 3 * y % 17, x, x + 30 + x % 50) for y, x in zip(
            range(0, 70, 7), range(0, 200, 17))]] * 2, 0, False),
    "width 1001": (1, 70, 1001, [
        [(3, 66, 0, 1001), (10, 40, 501, 998), (0, 70, 998, 1001)]], 0,
        False),
    "halo row, row_offset 3": (2, 64, 256, [
        [(0, 20, 5, 200), (2, 67, 100, 256)],
        [(-3, 10, 0, 256), (60, 80, 7, 9 + 4)]], 3, True),
}


def _inputs(name):
    b, h, w, rows, row_offset, with_halo = CASES[name]
    rng = np.random.default_rng(len(name))
    pgm = torch.from_numpy(rng.random((b, h, w), dtype=np.float32))
    halo = torch.from_numpy(rng.random((b, 2, w), dtype=np.float32)) \
        if with_halo else None
    return pgm, _boxes(b, rows), halo, row_offset


# Every case on both load paths, but width 1001 (no 16-byte rows) on the
# scalar one alone; on a grid of an H100's 2640 warps (items of
# MIN_SEG_ROWS rows at these sizes), of 40 and of 1 (of MAX_SEG_ROWS).
@pytest.mark.parametrize("warps", [2640, 40, 1])
@pytest.mark.parametrize("name,vec", [
    (name, vec) for name, case in CASES.items() for vec in (True, False)
    if not (vec and case[2] % sk.LANE_COLS)])
def test_k5_schedule_matches_plain(name, vec, warps):
    pgm, boxes, halo, row_offset = _inputs(name)
    s1, s2, visits = emulate_sharpness_sums(pgm, boxes, halo, row_offset,
                                            vec, warps)
    b, h, w = pgm.shape
    ys = torch.arange(h)[:, None] + row_offset
    xs = torch.arange(w)[None]
    for i in range(b):
        for k in range(10):
            top, bottom, left, right = boxes[i, k].tolist()
            want = ((ys >= top) & (ys < bottom) & (xs >= left)
                    & (xs < right)).long()
            assert torch.equal(visits[i, k], want), (i, k)
    w1, w2 = sk.sharpness_sums_plain(pgm, boxes, halo, row_offset)
    for got, want in ((s1, w1), (s2, w2)):
        assert bool(((got - want).abs() <= 1e-5 * want.abs()).all())
        assert torch.equal(got == 0, want == 0)


def test_box_spans_seg_rows_and_max_items():
    """The split of a box: rows clipped to the rows handed in, strips from
    x0 rounded down to a multiple of 4 only on the vector path; the items'
    rows: the strip-rows over the warps, within [MIN_SEG_ROWS,
    MAX_SEG_ROWS]; no box splits into more items than max_items counts."""
    boxes = np.zeros((1, 10, 4), np.int64)
    boxes[0, 0] = (-3, 40, 5, 200)
    boxes[0, 1] = (50, 60, 0, 10)       # below these rows
    boxes[0, 2] = (0, 45, 0, 1001)
    spans = box_spans(boxes, 45, 1001, 3, True)
    assert spans[0, 0].tolist() == [0, 37, 5, 200, 4, 2]
    assert not spans[0, 1].any()
    assert spans[0, 2].tolist() == [0, 42, 0, 1001, 0, 8]
    assert box_spans(boxes, 45, 1001, 3, False)[0, 0, 4] == 5
    strip_rows = 2 * 37 + 8 * 42
    assert seg_rows(spans, 1) == sk.MAX_SEG_ROWS
    assert seg_rows(spans, 10) == -(-strip_rows // 10)
    assert seg_rows(spans, 10 ** 6) == sk.MIN_SEG_ROWS
    items = spans[..., 5] * -(-(spans[..., 1] - spans[..., 0])
                              // sk.MIN_SEG_ROWS)
    assert items.max() <= sk.max_items(1, 45, 1001) // 10
