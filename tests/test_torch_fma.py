"""The palette's multiply-adds against the JAX package as ``get_report``
runs it, jitted, on the CPU.

Inside ``jax.jit`` XLA contracts a float32 multiply followed by an add
into one fused multiply-add (FMA), which rounds once.  Two of the JAX
package's multiply-adds decide something discrete: the tie-break distance
``hd * hd + sd * sd + vd * vd`` (quantize.palette_pixel_sums), which XLA
computes as ``fma(vd, vd, fma(sd, sd, hd * hd))``, picks a pixel's parent
on a near-tie, and the saliency weight ``qw + svw * s_v``, one FMA, feeds
K2's margin comparator.  The port computes both with ``stats.fma_f32``
(and the CUDA kernel with ``__fmaf_rn``).  Here: ``fma_f32`` bit for bit
against XLA's contracted multiply-add; the HSV planes the distance reads;
the distance on pixels where the two roundings pick other parents; the
saliency at four configs and a constructed order it decides; and
``get_report`` on frames where the unfused forms move a pixel (360x512
noise, seed 11, default grid: one pixel; seed 1 at 12x3x2)."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.config import ReportConfig as JCfg
from photohive_dsp_tpu.ops import colorspace as jcs
from photohive_dsp_tpu.ops import pallas_kernels as jpk
from photohive_dsp_tpu.ops import pallas_kernels_bf16 as jpkv
from photohive_dsp_tpu.ops import pallas_kernels_cwide as jpkc
from photohive_dsp_tpu.ops import quantize as jq

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.config import ReportConfig as TCfg
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops import quantize as tq
from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
    u8_to_unit_f32
from photohive_dsp_tpu_torch.ops.margin_sort import margin_insertion_argsort
from photohive_dsp_tpu_torch.ops.stats import fma_f32

from .test_torch_pipeline import assert_match, report_fields

f32 = np.float32
XLA_MULADD = jax.jit(lambda a, b, c: a * b + c)


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def random_triples(n: int, seed: int):
    """n float32 (a, b, c), signed, magnitudes 2^-20..2^20 (no subnormal
    product or sum: XLA's CPU runtime flushes those to zero)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n)))
            .astype(f32) for _ in range(3)]


def midpoint_triples(n: int, seed: int):
    """n (a, b, c) whose exact a * b + c lies just off a float32 midpoint
    and whose float64 sum lands on it: a = 1 + 2^-23, b = +-ulp(c) / 2 *
    (1 - 2^-23), so a * b = +-ulp(c) / 2 * (1 - 2^-46); c has an odd
    significand, so ties-to-even from the float64 sum takes the wrong
    neighbour."""
    rng = np.random.default_rng(seed)
    sig = (rng.integers(1 << 23, 1 << 24, n) | 1).astype(np.float64)
    c = (sig * np.exp2(rng.integers(-40, 40, n) - 23)
         * rng.choice([-1.0, 1.0], n)).astype(f32)
    half_ulp = np.spacing(np.abs(c)).astype(f32) / f32(2)
    b = (half_ulp * f32(1 - 2.0 ** -23)
         * rng.choice([-1.0, 1.0], n).astype(f32)).astype(f32)
    return np.full(n, 1 + 2.0 ** -23, f32), b, c


@pytest.mark.parametrize("kind", ["random", "midpoints"])
def test_fma_f32_matches_xla_contracted_multiply_add(kind):
    a, b, c = random_triples(10 ** 6, 0) if kind == "random" else \
        midpoint_triples(4096, 1)
    want = np.asarray(XLA_MULADD(a, b, c))
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c)))
    assert got.dtype == torch.float32
    assert np.array_equal(bits(got.numpy()), bits(want))
    if kind == "random":
        # XLA does contract: the unfused form differs on many triples.
        assert (a * b + c != want).sum() > 10 ** 4
    else:
        # Every one of them is a case the float64 sum alone gets wrong.
        naive = (a.astype(np.float64) * b + c).astype(f32)
        assert (naive != want).all()
    # Python scalars take float32, as the saliency weight passes them.
    scalar = fma_f32(float(a[0]), torch.from_numpy(b[:5]), float(c[0]))
    assert np.array_equal(bits(scalar.numpy()),
                          bits(np.asarray(XLA_MULADD(a[0], b[:5], c[0]))))


def test_hsv_planes_match_jitted_jax():
    """The planes the distance reads: h, s, v of every 16th uint8 triple,
    bit-equal to jitted JAX's."""
    i = np.arange(0, 1 << 24, 16, dtype=np.uint32)
    u8 = np.stack([i >> 16, (i >> 8) & 255, i & 255]).astype(np.uint8)
    planes = u8_to_unit_f32(torch.from_numpy(u8))
    got = rgb_to_hsv(*planes)
    want = jax.jit(jcs.rgb_to_hsv)(*(jnp.asarray(p.numpy()) for p in planes))
    for g, w in zip(got, want):
        assert np.array_equal(bits(g.numpy()), bits(w))


JCFG, TCFG = JCfg(), TCfg()
C = TCFG.num_cells
# Pixels (flat index) of seeded noise frames whose parent the distance's
# rounding decides at the default grid: the FMAs pick another slot than
# three rounded adds.
NEAR_TIES = {"1080x1920 seed 5": ((1080, 1920), 5, [529788, 1153689]),
             "360x512 seed 11": ((360, 512), 11, [69964])}


def noise(hw, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, hw + (3,),
                                                dtype=np.uint8)


@functools.partial(jax.jit, static_argnums=1)
def jax_assign(counts, total: int, tables):
    """The JAX package's parent assignment with the tables as arguments,
    jitted as get_report runs it."""
    s_v_f32 = tables.s_v_f32
    order = jq.margin_insertion_argsort(jq.saliency_f32(counts, s_v_f32,
                                                        JCFG))
    return jq.parent_assignment_from_order(counts, order, total, JCFG,
                                           tables)


@functools.lru_cache(maxsize=None)
def near_tie_case(name):
    """The frame's counts and both packages' assignments, the near-tie
    pixels as a (1, 3, 1, n) uint8 frame."""
    hw, seed, idx = NEAR_TIES[name]
    img = noise(hw, seed)
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(img, -1, 0)[None]))
    counts, _ = tpk.cell_counts_s_from_rgb(x, TCFG)
    jt, tt = jq.OctreeTables.for_config(JCFG), tq.OctreeTables.for_config(
        TCFG)
    sal = tq.saliency_f32(counts, tt.s_v_f32, TCFG)
    ta = tq.parent_assignment_from_order(
        counts, margin_insertion_argsort(sal), hw[0] * hw[1], TCFG, tt)
    ja = jax_assign(jnp.asarray(counts.numpy()[0]), hw[0] * hw[1], jt)
    px = np.ascontiguousarray(img.reshape(-1, 3)[idx].T[None, :, None, :])
    return jt, tt, ja, ta, px


def unfused_slots(px, cand, ctr) -> np.ndarray:
    """Each pixel's first-minimum slot with the distance rounded after
    every operation, in numpy float32."""
    h, s, v, cells = (t.numpy()[0] for t in tpk._hsv_cells(
        torch.from_numpy(px), TCFG))
    out = []
    for p, cell in enumerate(cells):
        ks = [int(k) for k in cand[0, cell] if k < C]
        m = ctr[0, ks]
        hd = np.abs(h[p] - m[:, 0])
        hd = np.where(hd > f32(180), f32(360) - hd, hd) * f32(1 / 360.0)
        sd, vd = s[p] - m[:, 1], v[p] - m[:, 2]
        out.append(ks[int(np.argmin(hd * hd + sd * sd + vd * vd))])
    return np.array(out)


@pytest.mark.parametrize("name", list(NEAR_TIES))
def test_distance_matches_jitted_palette_pixel_sums(name):
    """On the near-tie pixels, with the frame's own assignment: the port's
    plain K4 puts each pixel in the parent jitted
    quantize.palette_pixel_sums does, and three rounded adds would not."""
    jt, tt, ja, ta, px = near_tie_case(name)
    for field in ja._fields:
        assert np.array_equal(getattr(ta, field).numpy()[0],
                              np.asarray(getattr(ja, field))), field
    cand, ctr = tpk.palette_candidate_table(ta, tt, C, 8)
    got = tpk.palette_sums_by_k_rgb(torch.from_numpy(px), cand, ctr, TCFG)
    order = np.asarray(ja.order)
    for p in range(px.shape[-1]):
        one = jnp.asarray(px[0, :, :, p:p + 1])
        h, s, v = jax.jit(lambda r: jcs.rgb_to_hsv(
            *jcs.u8_to_unit_f32(r)))(one)
        cells = jax.jit(lambda h, s, v: jq.assign_cells(h, s, v, JCFG))(
            h, s, v)
        sums = jax.jit(lambda h, s, v, c, a, t: jq.palette_pixel_sums(
            h, s, v, c, a, JCFG, t, q_pad=8))(h, s, v, cells, ja, jt)
        want_slot = int(np.nonzero(np.asarray(sums)[order, 3])[0][0])
        mine = tpk.palette_sums_by_k_rgb(torch.from_numpy(
            np.ascontiguousarray(px[..., p:p + 1])), cand, ctr, TCFG)
        assert int(torch.nonzero(mine[0, :, 3])[0, 0]) == want_slot
        assert unfused_slots(px[..., p:p + 1], cand.numpy(),
                             ctr.numpy())[0] != want_slot
    assert int(got[..., 3].sum()) == px.shape[-1]


@pytest.mark.parametrize("name", list(NEAR_TIES))
def test_distance_matches_bf16_and_cwide_interpret_kernels(name):
    """The JAX package's bf16 (K4) and C-wide (K14) Pallas kernels in
    interpret mode contract the distance as its XLA pass does, and agree
    with the port's plain versions on the near-tie pixels.  (Its
    candidate kernels, K10 and K13, contract it as fma(vd, vd, fma(hd, hd,
    sd * sd)) there and so disagree with its own XLA pass on these
    pixels; the port follows get_report.)"""
    jt, tt, ja, ta, px = near_tie_case(name)
    tile = np.zeros((1, 3, 16, 256), np.uint8)
    tile[..., 0, :px.shape[-1]] = px[:, :, 0]
    tile[..., 1:, :] = 255          # the white cell: no tie to break
    cand, ctr = tpk.palette_candidate_table(ta, tt, C, 8)
    got = tpk.palette_sums_by_k_rgb(torch.from_numpy(tile), cand, ctr, TCFG)
    with pltpu.force_tpu_interpret_mode():
        luts = jax.vmap(lambda a: jpk.palette_candidate_lut(a, jt, C, 8))(
            jax.tree.map(lambda t: t[None], ja))
        want = jpkv.palette_sums_by_k_rgb(jnp.asarray(tile), luts, C, 8,
                                          JCFG)
    assert np.array_equal(got[..., 3].numpy(), np.asarray(want)[..., 3])

    h, s, v = (t.reshape(1, -1).contiguous() for t in rgb_to_hsv(
        *u8_to_unit_f32(torch.from_numpy(tile[0]))))
    bitmask, centers_by_k = tpk.cwide_tables(ta, tt)
    got14 = tpk.palette_sums_from_fixed(tpk.palette_sums_by_k_cwide(
        h, s, v, bitmask, centers_by_k, TCFG))
    allowed_t = jnp.asarray(np.swapaxes(ta.allowed.numpy(), 1, 2),
                            jnp.float32)
    cols = [jnp.broadcast_to(jnp.asarray(centers_by_k.numpy()[..., i])[
        ..., None], (1, C, 128)) for i in range(3)]
    with pltpu.force_tpu_interpret_mode():
        want14 = jpkc.palette_sums_by_k_cwide(
            *(jnp.asarray(t.numpy()) for t in (h, s, v)), allowed_t, *cols,
            C, JCFG)
    assert np.array_equal(got14[..., 3].numpy(), np.asarray(want14)[..., 3])


SALIENCY_CFGS = {"default": {},
                 "12x3x2": dict(h_partitions=12, s_partitions=3,
                                v_partitions=2),
                 "36x4x4": dict(h_partitions=36, s_partitions=4,
                                v_partitions=4),
                 "weights 0.3/0.7": dict(quantity_weight=0.3,
                                         saturation_value_weight=0.7)}


@pytest.mark.parametrize("name", list(SALIENCY_CFGS))
def test_saliency_matches_jitted_jax(name):
    """saliency_f32 bit-equal to the JAX package's, jitted with the tables
    as arguments; the weight rounded twice differs on some cells."""
    jcfg, tcfg = JCfg(**SALIENCY_CFGS[name]), TCfg(**SALIENCY_CFGS[name])
    sv = tq.OctreeTables.for_config(tcfg).s_v_f32
    c = tcfg.num_cells
    counts = np.random.default_rng(4).integers(0, 10 ** 6, (3, c)).astype(
        np.int32)
    counts[0] = 1                   # the weights themselves, times 1000
    want = jax.jit(jax.vmap(lambda x, s: jq.saliency_f32(x, s, jcfg),
                            in_axes=(0, None)))(counts, sv.numpy())
    got = tq.saliency_f32(torch.from_numpy(counts), sv, tcfg)
    assert np.array_equal(bits(got.numpy()), bits(want))
    unfused = f32(tcfg.quantity_weight) + f32(
        tcfg.saturation_value_weight) * sv.numpy()
    assert (unfused * f32(1000) != np.asarray(want)[0]).any()


def test_margin_order_follows_the_fused_weight():
    """Counts on which the weight's rounding decides K2's order: cell 5
    (its weight an ulp off when rounded twice) at 20000 pixels and cell
    108 at 138575 lie within the comparator's unit margin of each other
    one way and not the other.  The port's order equals
    margin_insertion_argsort of jitted JAX saliencies."""
    sv = tq.OctreeTables.for_config(TCFG).s_v_f32
    counts = torch.zeros((1, C), dtype=torch.int32)
    counts[0, 5], counts[0, 108] = 20000, 138575
    want = jax.jit(jax.vmap(lambda x, s: jq.margin_insertion_argsort(
        jq.saliency_f32(x, s, JCFG)), in_axes=(0, None)))(
        jnp.asarray(counts.numpy()), sv.numpy())
    got = margin_insertion_argsort(tq.saliency_f32(counts, sv, TCFG))
    assert np.array_equal(got.numpy(), np.asarray(want))
    unfused = counts.float() * (TCFG.quantity_weight
                                + TCFG.saturation_value_weight * sv) * 1000.0
    assert not torch.equal(margin_insertion_argsort(unfused), got)


@pytest.mark.parametrize("seed,knobs", [
    (11, {}), (1, dict(h_partitions=12, s_partitions=3, v_partitions=2))],
    ids=["seed11_default", "seed1_12x3x2"])
def test_get_report_matches_jax_on_near_tie_frames(seed, knobs):
    """360x512 noise frames on which the unfused distance and weight move
    a pixel's parent: the port's get_report on the CPU meets
    assert_match's bars against the JAX package's, percentages exact."""
    img = noise((360, 512), seed)
    want = ph.get_report(img, **knobs)
    got = pt.get_report(img, device="cpu", **knobs)
    assert_match(report_fields(got), report_fields(want))
