"""Quantized training (`use_quantized_grad`) in the port against the JAX
package, on the CPU.

  * `quantize_gradients` (`ops/fused.py`) bitwise, with and without a
    threefry key, `const_hess_level` 0 and 15, 4 to 15 bins;
  * `quantized_lattice_rows` bitwise, and its debug check;
  * K4's plain version (`ops/hist_kernel_q.py`) bitwise against
    `pallas_histogram_multi_quantized_rows(interpret=True)` and
    `leaf_histogram_packed_multi` at S = 1, 5 (a pad slot), 42 and 43 (two
    chunks), u8 and u16 bins; the port's packed histograms bitwise against
    the reference's;
  * the kernels' first stage on the CPU: the 42-slot row lists and
    lattice words (`hist_kernel.row_lists_plain`) against a row-by-row
    oracle, with repeated and empty slots; the planner
    (`launch_plan_q`) for every S from 1 to 42, u8 and u16; the
    kernel's path (`histogram_multi_quantized_pieces`: lists, pieces,
    integer partials, their sum) bitwise the plain version;
  * K5's plain version bitwise against
    `pallas_fused_hist_split_quantized_rows(interpret=True)`, histogram
    and candidates;
  * the strict and wave growers on a quantized payload against the
    reference's (`hist_impl="packed"`, `packed_const_hess_level=0`, the
    scales in `feat["qscales"]`): every `DeviceTree` field bitwise, on the
    port's K4/K5 family (plain versions) and packed path; fused and
    unfused wave trees byte-identical;
  * `lt.train` against `lgb.train` with quantized gradients: regression
    with `hist_impl="packed"` on both sides, leaf values bitwise; binary
    with `auto` on both sides (the reference resolves to `packed` with
    `const_hess_level` 0, the port to the K4/K5 family), structure equal
    and leaf values within the golden tolerance; both growers,
    stochastic rounding on and off, 4 and 15 bins; multiclass;
    `segment_sum` with quantized gradients;
  * `hist_impl` resolution: auto, packed, pallas_q, pallas_fused_q,
    segment_sum, the priced warning, the wave width cap of 42.
"""
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.ops import histogram as ref_hist  # noqa: E402
from lightgbm_tpu.ops import pallas_hist as ref_pallas  # noqa: E402
from lightgbm_tpu.ops.fused import \
    quantize_gradients as ref_quantize  # noqa: E402
from lightgbm_tpu.ops.grow import GrowerSpec as RefSpec  # noqa: E402
from lightgbm_tpu.ops.grow import make_grower as ref_grower  # noqa: E402
from lightgbm_tpu.ops.grow_wave import \
    make_wave_grower as ref_wave_grower  # noqa: E402
from lightgbm_tpu_torch.ops import fused_kernel, grow_wave  # noqa: E402
from lightgbm_tpu_torch.ops import hist_kernel_q as hq  # noqa: E402
from lightgbm_tpu_torch.ops import histogram as port_hist  # noqa: E402
from lightgbm_tpu_torch.ops import threefry  # noqa: E402
from lightgbm_tpu_torch.ops.fused import quantize_gradients  # noqa: E402
from lightgbm_tpu_torch.ops.grow import GrowerSpec, make_grower  # noqa: E402
from test_torch_train import _assert_same_trees  # noqa: E402
from test_torch_wave import FIELDS, _assert_trees_equal  # noqa: E402

MB = 32
SCAN_KW = dict(l1=0.2, l2=1.0, min_data_in_leaf=5.0, min_sum_hessian=1e-3,
               min_gain_to_split=0.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Gradients and links go through sigmoid and softmax: one intra-op
    thread keeps this CPU torch build's first-call `exp` fault out of
    the comparison (ROADMAP Queue 3 (f))."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x))
    return x.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[x.itemsize])


def _assert_bitwise(got, want, ctx=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, ctx
    assert np.array_equal(_bits(got), _bits(want)), ctx


def _grads(seed=0, n=3000, shape=None):
    rng = np.random.RandomState(seed)
    shape = shape or (n,)
    g = (rng.randn(*shape) * 0.7).astype(np.float32)
    h = (0.02 + rng.rand(*shape) * 0.25).astype(np.float32)
    return g, h


# ------------------------------------------------------------ quantizer
@pytest.mark.parametrize("keyed", [False, True], ids=["round", "stochastic"])
@pytest.mark.parametrize("chl", [0, 15])
@pytest.mark.parametrize("n_bins", [4, 7, 13, 15])
def test_quantize_gradients_matches(n_bins, chl, keyed):
    g, h = _grads(n_bins)
    kj = jax.random.fold_in(jax.random.PRNGKey(3), 7) if keyed else None
    kp = threefry.fold_in(threefry.prng_key(3), 7) if keyed else None
    want = ref_quantize(jnp.asarray(g), jnp.asarray(h), n_bins, kj,
                        return_scales=True, const_hess_level=chl)
    got = quantize_gradients(torch.from_numpy(g), torch.from_numpy(h),
                             n_bins, kp, return_scales=True,
                             const_hess_level=chl)
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[2][0], want[2][0]),
                 (got[2][1], want[2][1])):
        _assert_bitwise(a, b, (n_bins, chl, keyed))
    plain = quantize_gradients(torch.from_numpy(g), torch.from_numpy(h),
                               n_bins, kp, const_hess_level=chl)
    assert len(plain) == 2 and torch.equal(plain[0], got[0])


def test_quantize_gradients_of_a_class_matrix_matches():
    """Multiclass quantizes the full [N, K] arrays with one scale."""
    g, h = _grads(1, shape=(1500, 3))
    kj = jax.random.fold_in(jax.random.PRNGKey(5), 1)
    kp = threefry.fold_in(threefry.prng_key(5), 1)
    want = ref_quantize(jnp.asarray(g), jnp.asarray(h), 15, kj)
    got = quantize_gradients(torch.from_numpy(g), torch.from_numpy(h), 15,
                             kp)
    _assert_bitwise(got[0], want[0])
    _assert_bitwise(got[1], want[1])


# ------------------------------------------------------------ histograms
def _lattice_case(seed=0, n=3000, f=6, mb=MB, dtype=np.uint8, leaves=45):
    """Bins, the quantized payload of `_grads` (stochastic rounding, 15
    bins, one row in five out of the bag with w = 0), its scales and
    leaf ids; the reference's and the port's lattices."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, mb, (f, n)).astype(dtype)
    g, h = _grads(seed, n)
    gq, hq_, (sg, sh) = ref_quantize(jnp.asarray(g), jnp.asarray(h), 15,
                                     jax.random.PRNGKey(seed),
                                     return_scales=True)
    w = (rng.rand(n) < 0.8).astype(np.float32)
    pay = np.stack([np.asarray(gq) * w, np.asarray(hq_) * w, w],
                   axis=1).astype(np.float32)
    lid = rng.randint(0, leaves, n).astype(np.int32)
    sg, sh = np.asarray(sg), np.asarray(sh)
    pw_ref = np.asarray(ref_pallas.quantized_lattice_rows(
        jnp.asarray(pay), sg, sh))
    pw = hq.quantized_lattice_rows(torch.from_numpy(pay), torch.tensor(sg),
                                   torch.tensor(sh))
    return dict(bins=bins, pay=pay, sg=sg, sh=sh, lid=lid, pw_ref=pw_ref,
                pw=pw, mb=mb)


@pytest.fixture(scope="module")
def lattice():
    return _lattice_case()


def test_lattice_rows_match(lattice):
    _assert_bitwise(lattice["pw"], lattice["pw_ref"])
    assert lattice["pw"].dtype == torch.int8
    pay = torch.from_numpy(lattice["pay"]).clone()
    pay[3, 2] = 0.5
    with pytest.raises(FloatingPointError, match="precondition"):
        hq.quantized_lattice_rows(pay, torch.tensor(lattice["sg"]),
                                  torch.tensor(lattice["sh"]), debug=True)


def _k4_both(c, slots):
    want = ref_pallas.pallas_histogram_multi_quantized_rows(
        jnp.asarray(c["bins"]), jnp.asarray(c["pw_ref"]),
        jnp.asarray(c["lid"]), jnp.asarray(slots, jnp.int32), c["mb"],
        c["sg"], c["sh"], interpret=True)
    got = hq.histogram_multi_quantized(
        torch.from_numpy(c["bins"]), c["pw"], torch.from_numpy(c["lid"]),
        torch.tensor(slots, dtype=torch.int32), c["mb"],
        torch.tensor(c["sg"]), torch.tensor(c["sh"]))
    return got, want


K4_SLOTS = {"s1": [0], "s5_pad": [3, 1, 99, 5, 7], "s42": list(range(42)),
            "s43": list(range(43))}


@pytest.mark.parametrize("name", list(K4_SLOTS))
def test_k4_plain_matches_pallas_and_packed(lattice, name):
    slots = K4_SLOTS[name]
    got, want = _k4_both(lattice, slots)
    _assert_bitwise(got, want, name)
    packed = ref_hist.leaf_histogram_packed_multi(
        jnp.asarray(lattice["bins"]), jnp.asarray(lattice["pay"]),
        jnp.asarray(lattice["lid"]), jnp.asarray(slots, jnp.int32), MB,
        lattice["sg"], lattice["sh"])
    _assert_bitwise(got, packed, name)
    if 99 in slots:
        assert not bool(got[slots.index(99)].any())


def test_k4_plain_matches_pallas_on_u16_bins():
    c = _lattice_case(seed=2, n=2500, f=4, mb=300, dtype=np.uint16,
                      leaves=6)
    got, want = _k4_both(c, [0, 4, 2, 77])
    _assert_bitwise(got, want)


@pytest.mark.parametrize("chl", [0, 15])
def test_packed_histograms_match(lattice, chl):
    c = lattice
    if chl:   # a declared unit hessian: every live row at hq = level
        pay = c["pay"].copy()
        pay[:, 1] = pay[:, 2]
        sh = np.float32(1.0 / chl)
    else:
        pay, sh = c["pay"], c["sh"]
    slots = [4, 0, 99, 2]
    want = ref_hist.leaf_histogram_packed_multi(
        jnp.asarray(c["bins"]), jnp.asarray(pay), jnp.asarray(c["lid"]),
        jnp.asarray(slots, jnp.int32), MB, c["sg"], sh, const_hess_level=chl)
    got = port_hist.leaf_histogram_packed_multi(
        torch.from_numpy(c["bins"]), torch.from_numpy(pay),
        torch.from_numpy(c["lid"]), torch.tensor(slots, dtype=torch.int32),
        MB, torch.tensor(c["sg"]), torch.tensor(sh), chl)
    _assert_bitwise(got, want, chl)
    mask = c["lid"] == 3
    want1 = ref_hist.leaf_histogram_packed(
        jnp.asarray(c["bins"]), jnp.asarray(pay), jnp.asarray(mask), MB,
        c["sg"], sh, const_hess_level=chl)
    got1 = port_hist.leaf_histogram_packed(
        torch.from_numpy(c["bins"]), torch.from_numpy(pay),
        torch.from_numpy(mask), MB, torch.tensor(c["sg"]), torch.tensor(sh),
        chl)
    _assert_bitwise(got1, want1, chl)


def test_k5_plain_matches_pallas(lattice):
    c = lattice
    slots = [3, 1, 99, 5, 7]
    f = c["bins"].shape[0]
    nb = np.array([MB, 17, MB, MB, MB, 20][:f], np.int32)
    miss = np.array([0, 0, 2, 0, 1, 2][:f], np.int32)
    par = (np.random.RandomState(4).rand(len(slots), 3)
           * [1.0, 40.0, 80.0]).astype(np.float32)
    hj, cj = ref_pallas.pallas_fused_hist_split_quantized_rows(
        jnp.asarray(c["bins"]), jnp.asarray(c["pw_ref"]),
        jnp.asarray(c["lid"]), jnp.asarray(slots, jnp.int32), jnp.asarray(nb),
        jnp.asarray(miss), jnp.asarray(par), MB, c["sg"], c["sh"],
        interpret=True, **SCAN_KW)
    hp, cp = fused_kernel.fused_hist_split_quantized(
        torch.from_numpy(c["bins"]), c["pw"], torch.from_numpy(c["lid"]),
        torch.tensor(slots, dtype=torch.int32), torch.from_numpy(nb),
        torch.from_numpy(miss), torch.from_numpy(par), MB,
        torch.tensor(c["sg"]), torch.tensor(c["sh"]), **SCAN_KW)
    _assert_bitwise(hp, hj)
    _assert_bitwise(cp, cj)


def test_k4_wrapper_checks_its_inputs(lattice):
    c = lattice
    bins = torch.from_numpy(c["bins"])
    lid = torch.from_numpy(c["lid"])
    sl = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(lt.LightGBMError, match="int8"):
        hq.histogram_multi_quantized(bins, c["pw"].to(torch.int32), lid, sl,
                                     MB, 1.0, 1.0)
    with pytest.raises(lt.LightGBMError, match="slots"):
        hq.histogram_multi_quantized(bins, c["pw"], lid,
                                     torch.zeros(0, dtype=torch.int32), MB,
                                     1.0, 1.0)
    plan = hq.launch_plan_q(2_000_000, 28, 42, 256)
    assert plan.smem == hq.q_smem_bytes(plan.feature_group, 256)
    assert plan.smem <= 227 * 1024
    assert plan.groups == -(-28 // plan.feature_group)
    with pytest.raises(lt.LightGBMError, match="slots"):
        hq.launch_plan_q(1000, 28, 43, 256)
    limit = hq.q_max_bin_limit()
    assert limit >= 19370            # every max_bin the old grid took
    hq.launch_plan_q(1000, 28, 42, limit)
    with pytest.raises(lt.LightGBMError, match=f"max_bin up to {limit}"):
        hq.launch_plan_q(1000, 28, 1, limit + 1)


def _row_lists_by_hand(lid, slots, pw3):
    """The row lists one row at a time: each row goes to the first slot
    equal to its leaf id; counts per (slot, 8192-row block); offsets
    their exclusive prefix over (slot, block); the list slot by slot in
    row order, with each listed row's lattice bytes."""
    n, nb = lid.size, -(-lid.size // 8192)
    counts = np.zeros((len(slots), nb), np.int64)
    per_slot = [[] for _ in slots]
    for r in range(n):
        for k, sl in enumerate(slots):
            if lid[r] == sl:
                counts[k, r // 8192] += 1
                per_slot[k].append(r)
                break
    offsets = np.zeros_like(counts)
    run = 0
    for k in range(len(slots)):
        for b in range(nb):
            offsets[k, b] = run
            run += counts[k, b]
    rows = [r for k in range(len(slots)) for r in per_slot[k]]
    starts = [offsets[k, 0] for k in range(len(slots))] + [run]
    u = pw3.view(np.uint8).astype(np.uint32)
    words = [int(u[0, r]) | int(u[1, r]) << 8 | int(u[2, r]) << 16
             for r in rows]
    return counts, offsets, starts, rows, words


ROW_LIST_SLOTS = {
    "s42": list(range(42)),
    "s42_repeats_and_empty": [5, 0, 5, 99, 1, 2, 0] + list(range(6, 41)),
    "s1": [3],
    "s14_reversed": list(range(13, -1, -1)),
}


@pytest.mark.parametrize("name", list(ROW_LIST_SLOTS))
def test_row_lists_model_matches_a_row_by_row_oracle(name):
    """`hist_kernel.row_lists_plain`, the list, counts, offsets, slot
    starts and lattice words as `row_count_kernel<42>` and
    `row_list_kernel<42, true>` build them, against a row-by-row oracle
    over three 8192-row blocks (a partial last one)."""
    from lightgbm_tpu_torch.ops.hist_kernel import row_lists_plain
    rng = np.random.RandomState(11)
    n = 2 * 8192 + 777
    lid = rng.randint(0, 45, n).astype(np.int32)
    pw3 = rng.randint(-128, 128, (3, n)).astype(np.int8)
    slots = ROW_LIST_SLOTS[name]
    got = row_lists_plain(torch.from_numpy(lid),
                          torch.tensor(slots, dtype=torch.int32),
                          torch.from_numpy(pw3))
    counts, offsets, starts, rows, words = _row_lists_by_hand(lid, slots,
                                                              pw3)
    assert np.array_equal(got.counts, counts)
    assert np.array_equal(got.offsets, offsets)
    assert got.slot_start.tolist() == starts
    assert got.list.tolist() == rows
    assert got.lattice.tolist() == words
    for k, sl in enumerate(slots):            # a repeat lists nothing
        if sl in slots[:k]:
            assert starts[k + 1] == starts[k]


@pytest.mark.parametrize("n", [1, 4097, 100_000, 2_000_000])
@pytest.mark.parametrize("mb", [255, 1023], ids=["u8", "u16"])
def test_launch_plan_q_covers_every_row_for_every_slot_count(mb, n):
    """K4's and K5's planner for S = 1 to 42: block within the 227 KB an
    H100 block can have, every (slot, feature) in exactly one block of
    the grid (S * groups, chunks), every listed row of a slot in exactly
    one piece, the scratch as the C side lays it out."""
    from lightgbm_tpu_torch.ops import hist_kernel as hk
    f = 28
    for s in range(1, 43):
        plan = hq.launch_plan_q(n, f, s, mb)
        assert 1 <= plan.feature_group <= min(f, hk._WARPS)
        assert plan.groups == -(-f // plan.feature_group)
        assert plan.smem == hq.q_smem_bytes(plan.feature_group, mb)
        assert plan.smem <= 232_448 and hk.blocks_per_sm(plan.smem) >= 1
        assert 1 <= plan.chunks <= min(65535, max(1, n))
        owners = np.zeros((s, f), np.int64)
        for x in range(s * plan.groups):
            f0 = (x % plan.groups) * plan.feature_group
            owners[x // plan.groups, f0:f0 + plan.feature_group] += 1
        assert np.all(owners == 1)
        for length in {0, 1, 255, 256, 4097, n // s, n}:
            bounds = hk.piece_bounds(length, plan.chunks)
            assert bounds[0] == 0 and bounds[-1] == length
            assert 1 <= bounds.size - 1 <= plan.chunks
            assert np.all(np.diff(bounds) >= min(length, 256))
    scratch, rowbuf, work = hq.q_first_stage_scratch(
        n, 42, f, mb, plan.chunks, torch.device("cpu"))
    assert work - rowbuf == 4 * (hk.row_scratch_ints(n, 42) + n)
    assert scratch.numel() == (hk.row_scratch_ints(n, 42) + n
                               + plan.chunks * 42 * f * mb * 3)


@pytest.mark.parametrize("name", list(K4_SLOTS)[:3] + ["repeats"])
def test_k4_kernel_path_model_equals_the_plain_version(lattice, name):
    """The kernel's path on the CPU (`histogram_multi_quantized_pieces`:
    the row lists, the planner's pieces, integer partials from the listed
    lattice words, their sum, the dequantize) is bitwise the plain
    version, including repeated and empty slots."""
    c = lattice
    slots = K4_SLOTS.get(name, [7, 2, 7, 99, 0, 2])
    args = (torch.from_numpy(c["bins"]), c["pw"], torch.from_numpy(c["lid"]),
            torch.tensor(slots, dtype=torch.int32), c["mb"],
            torch.tensor(c["sg"]), torch.tensor(c["sh"]))
    f, n = c["bins"].shape
    assert hq.launch_plan_q(n, f, len(slots), c["mb"]).chunks > 1
    _assert_bitwise(hq.histogram_multi_quantized_pieces(*args),
                    hq.histogram_multi_quantized_plain(*args), name)


def test_k4_kernel_path_model_on_u16_bins():
    c = _lattice_case(seed=3, n=20_000, f=3, mb=1023, dtype=np.uint16,
                      leaves=5)
    args = (torch.from_numpy(c["bins"]), c["pw"], torch.from_numpy(c["lid"]),
            torch.tensor([4, 0, 9, 1], dtype=torch.int32), c["mb"],
            torch.tensor(c["sg"]), torch.tensor(c["sh"]))
    _assert_bitwise(hq.histogram_multi_quantized_pieces(*args),
                    hq.histogram_multi_quantized_plain(*args))


# --------------------------------------------------------------- growers
def _grow_case(seed=7, n=3000, f=6):
    """The test_torch_wave bins and gradients, quantized (stochastic
    rounding, 15 bins) as the booster does for the lattice family."""
    rng = np.random.RandomState(seed)
    nb = np.full(f, MB, np.int32)
    nb[1] = 17
    missing = np.zeros(f, np.int32)
    missing[2] = 2
    missing[4] = 1
    default = np.zeros(f, np.int32)
    default[4] = 6
    bins = (rng.randint(0, 1 << 16, (f, n)) % nb[:, None]).astype(np.uint8)
    grad = (rng.randn(n) + 0.8 * (bins[0] > 12) - 0.6 * (bins[3] < 5))\
        .astype(np.float32)
    hess = (0.1 + rng.rand(n)).astype(np.float32)
    g, h, (sg, sh) = ref_quantize(jnp.asarray(grad), jnp.asarray(hess), 15,
                                  jax.random.PRNGKey(seed),
                                  return_scales=True)
    qs = np.array([np.asarray(sg), np.asarray(sh)], np.float32)
    return bins, np.asarray(g), np.asarray(h), nb, missing, default, qs


def _spec_kw(**over):
    kw = dict(num_leaves=15, max_depth=0, max_bin=MB, lambda_l1=0.0,
              lambda_l2=1.0, min_data_in_leaf=5.0,
              min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
              max_delta_step=0.0)
    kw.update(over)
    return kw


def _grow_ref(case, wave, **over):
    bins, g, h, nb, missing, default, qs = case
    f = len(nb)
    feat = dict(nb=jnp.asarray(nb), missing=jnp.asarray(missing),
                default=jnp.asarray(default), is_cat=jnp.zeros(f, bool),
                mono=jnp.zeros(f, jnp.int32), qscales=jnp.asarray(qs))
    spec = RefSpec(**_spec_kw(**over), hist_impl="packed",
                   packed_const_hess_level=0, has_cat=False)
    grow = (ref_wave_grower if wave else ref_grower)(spec)
    return grow(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                jnp.ones(len(g), jnp.float32), feat, jnp.ones(f, bool))


def _grow_port(case, wave, impl, fused=False, **over):
    bins, g, h, nb, missing, default, qs = case
    t = torch.from_numpy
    feat = dict(nb=t(nb), missing=t(missing), default=t(default),
                nb_np=nb, missing_np=missing, qscales=t(qs))
    spec = GrowerSpec(**_spec_kw(**over), hist_impl=impl, fused=fused)
    grow = (grow_wave.make_wave_grower if wave else make_grower)(spec)
    return grow(t(bins), t(g), t(h), torch.ones(len(g)), feat,
                torch.ones(len(nb), dtype=torch.bool))


@pytest.fixture(scope="module")
def grow_case():
    return _grow_case()


WAVE_OVER = dict(wave_width=4, wave_strict_tail=5, lambda_l1=0.2)


@pytest.mark.parametrize("wave", [False, True], ids=["strict", "wave"])
def test_quantized_trees_equal_the_references(grow_case, wave):
    over = WAVE_OVER if wave else dict(lambda_l1=0.2)
    want = _grow_ref(grow_case, wave, **over)
    paths = [("kernel_q", False), ("packed", False)]
    if wave:
        paths.append(("kernel_q", True))
    for impl, fused in paths:
        got = _grow_port(grow_case, wave, impl, fused=fused, **over)
        assert got.n_splits > 5
        _assert_trees_equal(got, want, (impl, fused))
    assert "leaf_id" in FIELDS


@pytest.mark.parametrize("over", [dict(wave_width=3), dict(
    wave_width=28, num_leaves=63, wave_strict_tail=8, lambda_l1=0.5)],
    ids=["w3", "w28"])
def test_quantized_fused_and_unfused_are_byte_identical(over):
    case = _grow_case(seed=11, n=4000)
    a = _grow_port(case, True, "kernel_q", fused=False, **over)
    b = _grow_port(case, True, "kernel_q", fused=True, **over)
    _assert_trees_equal(a, b, over)


# ------------------------------------------------------------ lt.train
#: (policy, stochastic_rounding, num_grad_quant_bins): each value of each
#: setting once per objective
QUANT_TRAIN = [("leafwise", True, 15), ("wave", False, 4)]


def _quant_params(case, policy, sr, n_bins, **extra):
    return dict(case["params"], use_quantized_grad=True,
                num_grad_quant_bins=n_bins, stochastic_rounding=sr,
                tree_grow_policy=policy, tpu_wave_width=4,
                tpu_wave_strict_tail=4, **extra)


def _train_pair(name, params, rounds=4):
    X, y = make_case_data(GOLDEN_CASES[name])
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y),
                   num_boost_round=rounds)
    bp = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, label=y),
                  num_boost_round=rounds)
    return bj, bp


@pytest.mark.parametrize("policy,sr,n_bins", QUANT_TRAIN,
                         ids=[f"{p}_sr{int(s)}_b{b}"
                              for p, s, b in QUANT_TRAIN])
def test_regression_packed_trains_bitwise(policy, sr, n_bins):
    params = _quant_params(GOLDEN_CASES["regression_l2"], policy, sr, n_bins,
                           hist_impl="packed")
    bj, bp = _train_pair("regression_l2", params)
    assert bp.hist_impl == "packed"
    assert bp._grower_spec.packed_const_hess_level == n_bins
    _assert_same_trees(bj, bp, bitwise=True)


@pytest.mark.parametrize("policy,sr,n_bins", QUANT_TRAIN,
                         ids=[f"{p}_sr{int(s)}_b{b}"
                              for p, s, b in QUANT_TRAIN])
def test_binary_auto_trains_like_the_reference(policy, sr, n_bins):
    """The reference resolves `auto` on its CPU to `packed` with
    `const_hess_level` 0 (binary is not a unit-hessian objective), the
    port to the K4/K5 family, fused on the wave: the same integer
    histograms.  Structure equal; leaf values within the golden
    tolerance (Queue 3 (c))."""
    params = _quant_params(GOLDEN_CASES["binary"], policy, sr, n_bins)
    bj, bp = _train_pair("binary", params)
    assert bp.hist_impl == "kernel_q"
    assert bp._grower_spec.fused == (policy == "wave")
    assert bj._grower_spec.packed_const_hess_level == 0
    _assert_same_trees(bj, bp)


def test_multiclass_auto_trains_like_the_reference():
    params = _quant_params(GOLDEN_CASES["multiclass"], "wave", True, 15)
    bj, bp = _train_pair("multiclass", params, rounds=2)
    _assert_same_trees(bj, bp)


def test_segment_sum_quantizes_then_trains_f32():
    params = _quant_params(GOLDEN_CASES["regression_l2"], "leafwise", True,
                           15, hist_impl="segment_sum")
    bj, bp = _train_pair("regression_l2", params, rounds=2)
    assert bp.hist_impl == "plain"
    _assert_same_trees(bj, bp, bitwise=True)


# ------------------------------------------------- hist_impl resolution
def _booster(**params):
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    return lt.Booster(dict({"objective": "binary", "verbosity": -1,
                            "device_type": "cpu", "num_leaves": 31},
                           **params),
                      lt.Dataset(X, label=(X[:, 0] > 0).astype(float)))


def test_hist_impl_resolution(caplog):
    q = {"use_quantized_grad": True}
    assert _booster(**q).hist_impl == "kernel_q"
    assert _booster().hist_impl == "kernel"
    assert _booster(hist_impl="packed", **q).hist_impl == "packed"
    assert _booster(hist_impl="segment_sum", **q).hist_impl == "plain"
    for impl in ("pallas_q", "pallas_fused_q"):
        with pytest.raises(lt.LightGBMError, match="CUDA device"):
            _booster(hist_impl=impl, **q)
    wave = _booster(tree_grow_policy="wave", **q)
    assert wave._grower_spec.fused and wave._grower_spec.hist_impl == \
        "kernel_q"
    assert not _booster(tree_grow_policy="wave", hist_impl="packed",
                        **q)._grower_spec.fused
    reg = _booster(objective="regression", hist_impl="packed",
                   num_grad_quant_bins=9, **q)
    assert reg._grower_spec.packed_const_hess_level == 9
    assert _booster(objective="regression", **q)._grower_spec \
        .packed_const_hess_level == 0
    caplog.set_level(logging.WARNING)
    assert _booster(hist_impl="packed", verbosity=0).hist_impl == "kernel"
    assert "hist_impl=packed is not available with use_quantized_grad=" \
        "False" in caplog.text
    caplog.clear()
    wide = _booster(num_grad_quant_bins=20, verbosity=0, **q)
    assert wide.hist_impl == "kernel"
    assert "hist_impl=quantized is not available with " \
        "num_grad_quant_bins=20 outside (0, 15]" in caplog.text
    wide.update()      # quantizes to 20 levels, then trains f32


def test_wave_width_cap_follows_the_family():
    q = {"use_quantized_grad": True, "tree_grow_policy": "wave"}
    assert _booster(tpu_wave_width=60, **q)._grower_spec.wave_width == 42
    assert _booster(tpu_wave_overgrow=2.0, **q)._grower_spec.wave_width == 42
    assert _booster(tpu_wave_width=60, tree_grow_policy="wave")\
        ._grower_spec.wave_width == 14
