"""The bounded serving tier of the port (`precision="bounded"`) against the
JAX package's.

* `compiler.quantize.pack_bounded` is the reference's field for field
  (codes, tiles, scales, bound, bytes) at 8 and 16 bits, and refuses
  what the reference refuses, with the same messages.
* The bounded sum's plain version (`ops/predict.py
  accumulate_slots_bounded_plain`, the arithmetic of `csrc/bounded.cu`)
  is bitwise the reference's `accumulate_slots_bounded`: the int32
  partials (scales of 1.0) and the f32 combine, which on XLA's CPU build
  LLVM contracts into fused multiply-adds (`_combine_tiles`).
* The bounded rung is bitwise the reference's bounded rung on every
  golden family, raw and converted, and within its published bound of
  `Booster.predict`; its compiled and stacked traversals give the same
  bytes; a doctored plane fails the refresh probe; a model outside the
  format serves its exact rung with the cause counted.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: E402
import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
import lightgbm_tpu_torch.serving.runtime as port_rt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.compiler import build_plan as jax_build_plan  # noqa: E402
from lightgbm_tpu.compiler import PlanNotCompilable as JaxRefused  # noqa
from lightgbm_tpu.compiler.quantize import \
    pack_bounded as jax_pack  # noqa: E402
from lightgbm_tpu.ops.predict import \
    accumulate_slots_bounded as jax_bounded  # noqa: E402
from lightgbm_tpu.serving import ServingRuntime as JaxRuntime  # noqa: E402
from lightgbm_tpu_torch import telemetry  # noqa: E402
from lightgbm_tpu_torch.compiler import PlanNotCompilable, build_plan  # noqa
from lightgbm_tpu_torch.compiler.quantize import pack_bounded  # noqa: E402
from lightgbm_tpu_torch.ops.predict import (  # noqa: E402
    accumulate_slots_bounded, accumulate_slots_bounded_plain,
    bounded_groups, predict_raw_ensemble_bounded)
from lightgbm_tpu_torch.serving import ServingClient  # noqa: E402

#: the tile budget both packages plan with here, so their tiles (and so
#: their scales and bounds) are the same
TILE_KB = 48.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the links, as in test_torch_serving.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _golden(name):
    path = ROOT / "tests" / "data" / f"golden_{name}.model.txt"
    X, _ = make_case_data(GOLDEN_CASES[name])
    return (lgb.Booster(model_file=str(path)),
            lt.Booster(model_file=str(path)), X[:700])


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    view = {8: np.uint64, 4: np.uint32, 2: np.uint16, 1: np.uint8}
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(view[a.dtype.itemsize]), b.view(view[b.dtype.itemsize]))


# ------------------------------------------------------------ the packer
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
@pytest.mark.parametrize("bits", [8, 16])
def test_pack_bounded_field_for_field(name, bits):
    bj, bp, _ = _golden(name)
    ex_j = bj.export_predict_arrays()
    ex_p = bp.export_predict_arrays()
    want = jax_pack(ex_j["trees"], jax_build_plan(ex_j, tile_vmem_kb=TILE_KB),
                    ex_j["leaf_values"], ex_j["num_class"], bits=bits)
    got = pack_bounded(ex_p["trees"], build_plan(ex_p, tile_vmem_kb=TILE_KB),
                       ex_p["leaf_values"], ex_p["num_class"], bits=bits)
    assert set(got) == set(want)
    for k in ("qval", "tile_of_tree", "scales"):
        assert got[k].dtype == want[k].dtype and _bits(got[k], want[k]), k
    for k in ("bound", "bits", "n_tiles", "bytes"):
        assert got[k] == want[k], k


def _fake_plan(tiles):
    return SimpleNamespace(buckets=[SimpleNamespace(tiles=tiles)])


@pytest.mark.parametrize("case", ["bits", "nonfinite", "overflow"])
def test_pack_bounded_refusals_match(case):
    rng = np.random.RandomState(0)
    t_trees = 600 if case == "overflow" else 4
    trees = [SimpleNamespace(num_leaves=3) for _ in range(t_trees)]
    values = rng.randn(t_trees, 3)
    bits = 16
    if case == "bits":
        bits = 4
    if case == "nonfinite":
        values[2, 1] = np.inf
    plan = _fake_plan([list(range(t_trees))])
    with pytest.raises(JaxRefused) as want:
        jax_pack(trees, plan, values, 1, bits=bits)
    with pytest.raises(PlanNotCompilable) as got:
        pack_bounded(trees, plan, values, 1, bits=bits)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- the bounded sum
@pytest.mark.parametrize("k,s_tiles,n,bits,unit", [
    (1, 7, 2003, 8, True), (1, 7, 2003, 8, False), (3, 5, 999, 16, True),
    (3, 5, 999, 16, False), (1, 1, 100, 8, False), (2, 2, 77, 8, False),
    (3, 40, 300, 16, False)])
def test_bounded_sum_bitwise_reference(k, s_tiles, n, bits, unit):
    """Scales of 1.0 show the int32 partials themselves; random scales
    over many magnitudes the f32 combine."""
    rng = np.random.RandomState(k * 100 + s_tiles)
    t_trees, nl = 300, 31
    dt = np.int8 if bits == 8 else np.int16
    qmax = (1 << (bits - 1)) - 1
    slots = rng.randint(0, nl, (t_trees, n)).astype(np.int32)
    qval = rng.randint(-qmax, qmax + 1, (t_trees, nl)).astype(dt)
    tile = np.sort(rng.randint(0, s_tiles, t_trees)).astype(np.int32)
    scales = (np.ones(s_tiles) if unit else
              rng.rand(s_tiles) * 10.0 ** rng.randint(-6, 2, s_tiles)
              ).astype(np.float32)
    cls = (np.arange(t_trees) % k).astype(np.int32)
    want = np.asarray(jax.jit(
        lambda *a: jax_bounded(*a, n_class=k, cls=cls if k > 1 else None))(
            slots, qval, tile, scales))
    args = [torch.from_numpy(a) for a in (slots, qval, tile, scales)]
    got = accumulate_slots_bounded_plain(*args, k).numpy()
    assert _bits(got, want)
    assert _bits(accumulate_slots_bounded(*args, k).numpy(), got)


def test_bounded_sum_gathers_through_gather_idx():
    """With `gather_idx` (the compiled plan's slot rows) the sum reads
    tree t's slots at row gather_idx[t], clamping out-of-range indices;
    the same as gathering the rows first."""
    rng = np.random.RandomState(5)
    t_trees, nl, n = 50, 9, 64
    slots = rng.randint(-3, nl + 3, (t_trees + 4, n)).astype(np.int32)
    gidx = rng.permutation(t_trees + 4)[:t_trees].astype(np.int32)
    qval = torch.from_numpy(rng.randint(-127, 128, (t_trees, nl))
                            .astype(np.int8))
    tile = torch.from_numpy(np.repeat(np.arange(5), 10).astype(np.int32))
    scales = torch.from_numpy(rng.rand(5).astype(np.float32))
    got = accumulate_slots_bounded_plain(
        torch.from_numpy(slots), qval, tile, scales, 2,
        torch.from_numpy(gidx))
    rows = torch.from_numpy(slots[gidx])
    assert torch.equal(got.view(torch.int32), accumulate_slots_bounded_plain(
        rows, qval, tile, scales, 2).view(torch.int32))


def test_bounded_groups_layout():
    tile = np.array([2, 0, 1, 0, 2, 2, 1], np.int32)
    g = bounded_groups(tile, 2, "cpu")
    # class 0: trees 0, 2, 4, 6 (tiles 2, 1, 2, 1); class 1: 1, 3, 5
    assert g.cls_start.tolist() == [0, 2, 4]
    assert g.grp_tile.tolist() == [1, 2, 0, 2]
    assert g.grp_start.tolist() == [0, 2, 4, 6, 7]
    assert g.grp_trees.tolist() == [2, 6, 0, 4, 1, 3, 5]


# ----------------------------------------------------------- the runtime
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
@pytest.mark.parametrize("bits", [8, 16])
def test_bounded_rung_bitwise_reference_and_within_bound(name, bits):
    bj, bp, X = _golden(name)
    jrt = JaxRuntime(bj, precision="bounded", quant_bits=bits,
                     tile_vmem_kb=TILE_KB)
    rt = lt.ServingRuntime(bp, device="cpu", precision="bounded",
                           quant_bits=bits)
    assert rt.rung == "bounded" and rt.bounded_active and jrt.bounded_active
    assert rt.bounded_bound == jrt.bounded_bound
    assert rt.bounded_measured_error == jrt.bounded_measured_error
    assert rt.bounded_measured_error <= rt.bounded_bound
    served = telemetry.REGISTRY.counter("serve.bounded")
    before = served.value
    for raw in (True, False):
        got = rt.predict(X, raw_score=raw)
        assert _bits(got, jrt.predict(X, raw_score=raw))
        err = float(np.max(np.abs(got.astype(np.float64)
                                  - bp.predict(X, raw_score=raw))))
        assert err <= rt.bounded_bound
    assert served.value == before + 2
    st = rt.status()["bounded"]
    assert st == {"active": True, "bound": rt.bounded_bound,
                  "measured_max_abs_error": rt.bounded_measured_error,
                  "disabled_cause": None}


def test_compiled_and_stacked_bounded_paths_agree():
    # the runtime's bounded rung traverses the plan whatever the exact
    # rung below it; the stacked program (kernel A, then the bounded sum
    # through the identity gather) gives the same bytes
    _, bp, X = _golden("multiclass")
    over_plan = lt.ServingRuntime(bp, device="cpu", precision="bounded")
    compiled_off = lt.ServingRuntime(bp, device="cpu", precision="bounded",
                                     compiled="off")
    assert compiled_off.rung == "bounded"
    assert compiled_off.status()["exact_rung"] == "device_sum"
    for rt in (over_plan, compiled_off):
        assert rt._state.dev.planes is not None
    d = over_plan._state.dev
    Xd = over_plan._stage32(X, len(X))
    conv = bp.objective_.convert_output
    for raw in (True, False):
        got = over_plan.predict(X, raw_score=raw)
        assert _bits(got, compiled_off.predict(X, raw_score=raw))
        stacked = predict_raw_ensemble_bounded(
            d.stacked, Xd, d.qval, d.tile, d.scales,
            over_plan.num_class, None if raw else conv)
        assert _bits(got, stacked.numpy())


def test_bounded_plane_bytes_under_a_third_of_compiled():
    _, bp, _ = _golden("binary")
    dev = lt.ServingRuntime(bp, device="cpu", precision="bounded")._state.dev
    bounded = sum(t.numel() * t.element_size()
                  for t in (dev.qval, dev.tile, dev.scales))
    compiled = sum(a.numel() * a.element_size() for bucket in dev.planes
                   for a in bucket if a is not None)
    assert bounded <= compiled / 3


def test_doctored_plane_fails_the_refresh_probe(monkeypatch):
    # scales silently x4, the bound left as packed: the measured error
    # passes the bound, and the port refuses the model (no lower rung
    # answers in its place)
    _, bp, _ = _golden("binary")
    orig = port_rt.pack_bounded

    def doctored(*a, **kw):
        out = orig(*a, **kw)
        out["scales"] = out["scales"] * np.float32(4.0)
        return out

    monkeypatch.setattr(port_rt, "pack_bounded", doctored)
    with pytest.raises(lt.LightGBMError,
                       match="bounded parity probe failed.*published bound"):
        lt.ServingRuntime(bp, device="cpu", precision="bounded")


@pytest.mark.parametrize("how", ["bits", "refused"])
def test_model_outside_the_format_serves_exact_with_cause(how, monkeypatch):
    _, bp, X = _golden("regression_l2")
    kw = {"quant_bits": 4} if how == "bits" else {}
    if how == "refused":
        def refuse(*a, **k):
            raise PlanNotCompilable("synthetic refusal")
        monkeypatch.setattr(port_rt, "pack_bounded", refuse)
    dis = telemetry.REGISTRY.counter("serve.bounded_disabled",
                                     cause="format")
    before = dis.value
    rt = lt.ServingRuntime(bp, device="cpu", precision="bounded", **kw)
    assert dis.value == before + 1
    assert rt.rung == "compiled" and not rt.bounded_active
    assert rt.status()["bounded"]["disabled_cause"] == "format"
    assert rt.bounded_bound is None
    assert np.array_equal(rt.predict(X[:100]), bp.predict(X[:100]))


def test_random_forest_bounded_is_disabled_as_model():
    text = (ROOT / "tests" / "data" / "golden_binary.model.txt").read_text()
    rf = text.replace("objective=binary sigmoid:1\n",
                      "objective=binary sigmoid:1\naverage_output\n")
    dis = telemetry.REGISTRY.counter("serve.bounded_disabled", cause="model")
    before = dis.value
    rt = lt.ServingRuntime(lt.Booster(model_str=rf), device="cpu",
                           precision="bounded")
    assert rt.rung == "slot_path" and dis.value == before + 1


def test_bad_precision_value_rejected():
    _, bp, _ = _golden("binary")
    with pytest.raises(ValueError, match="serve_precision"):
        lt.ServingRuntime(bp, device="cpu", precision="fuzzy")
    with pytest.raises(ValueError, match="compiled"):
        lt.ServingRuntime(bp, device="cpu", compiled="force")


def test_registry_publishes_bound_in_status():
    _, bp, X = _golden("binary")
    client = ServingClient(params={"serve_precision": "bounded",
                                   "device_type": "cpu",
                                   "serve_warmup": False})
    try:
        client.load("m", bp)
        blk = client.status()["bounded"]["m"]
        assert blk["active"] is True
        assert blk["measured_max_abs_error"] <= blk["bound"]
        p = client.predict(X[:100], model="m")
        assert float(np.max(np.abs(p.astype(np.float64)
                                   - bp.predict(X[:100])))) <= blk["bound"]
    finally:
        client.close()
