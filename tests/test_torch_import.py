"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, no file of it (or of chip_smoke.py) imports either, and its
runtime refuses to run without a GPU unless the CPU is asked for."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu_torch as lt  # noqa: E402

#: an import of jax, or of the JAX package (but not of lightgbm_tpu_torch)
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|lightgbm_tpu)\b(?!_torch)"
    r"|from\s+(jax|lightgbm_tpu)\b(?!_torch)[\w.]*\s+import)")


#: every module of the port, imported by the subprocess check below
MODULES = ("serving.runtime", "interop", "basic", "booster", "callback",
           "engine", "metrics", "objectives", "tree", "utils.config",
           "utils.efb", "utils.binning", "ops.grow", "ops.grow_wave",
           "ops.hist_kernel", "ops.fused_kernel", "ops.hist_kernel_q",
           "ops.fused", "ops.threefry", "ops.xla_math",
           "ops.histogram", "ops.reduce", "ops.split", "ops.predict",
           "compiler.kernel", "compiler._build", "compiler.plan",
           "compiler.quantize", "compiler.records", "utils.log", "sklearn",
           "contrib", "plotting", "convert", "utils.locks",
           "resilience.breaker", "resilience.faults", "resilience.supervise",
           "telemetry.metrics", "telemetry.sinks", "telemetry.spans",
           "telemetry.request_trace", "serving.batcher", "serving.client",
           "serving.http", "serving.registry", "rank_objective",
           "ops.renew", "cli", "datastore.format", "datastore.store",
           "datastore.prefetch", "datastore.assemble", "streaming.engine",
           "telemetry.memledger")


def test_every_module_is_listed():
    found = {".".join(p.relative_to(ROOT / "lightgbm_tpu_torch")
                      .with_suffix("").parts)
             for p in (ROOT / "lightgbm_tpu_torch").rglob("*.py")}
    found = {m for m in found if not m.endswith("__init__")}
    assert found == set(MODULES)


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys; import lightgbm_tpu_torch; "
            + "".join(f"import lightgbm_tpu_torch.{m}; " for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_line_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "lightgbm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{i}: {ln.strip()}"
           for f in files
           for i, ln in enumerate(f.read_text().splitlines(), 1)
           if _FORBIDDEN.match(ln)]
    assert bad == []
    assert _FORBIDDEN.match("import jax.numpy as jnp")
    assert _FORBIDDEN.match("from lightgbm_tpu.compiler import plan")
    assert not _FORBIDDEN.match("from lightgbm_tpu_torch import Booster")


def test_runtime_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bst = lt.Booster(model_file=str(
        ROOT / "tests" / "data" / "golden_binary.model.txt"))
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.ServingRuntime(bst)
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.ServingRuntime(bst, device="cuda")
    assert lt.ServingRuntime(bst, device="cpu").compiled_active


def test_kernel_wrappers_refuse_bad_inputs():
    from lightgbm_tpu_torch.compiler.kernel import traverse_bucket
    from lightgbm_tpu_torch.ops.predict import accumulate_slots_exact
    X = torch.zeros((300, 4), dtype=torch.float32)
    w = torch.zeros((1, 1, 1), dtype=torch.int32)
    pal = torch.zeros((1, 1), dtype=torch.float32)
    with pytest.raises(lt.LightGBMError, match="bucket-padded"):
        traverse_bucket(X, w, w.clone(), pal, None, 1, 0)
    with pytest.raises(lt.LightGBMError, match="float32"):
        traverse_bucket(X[:256].double(), w, w.clone(), pal, None, 1, 0)
    with pytest.raises(lt.LightGBMError, match="catw"):
        traverse_bucket(X[:256], w, w.clone(), pal, None, 1, 2)
    slots = torch.zeros((2, 8), dtype=torch.int32)
    gidx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(lt.LightGBMError, match="float64"):
        accumulate_slots_exact(slots, gidx, torch.zeros((2, 3)))
    with pytest.raises(lt.LightGBMError, match="multiclass"):
        accumulate_slots_exact(slots, gidx,
                               torch.zeros((2, 3), dtype=torch.float64), 2)
