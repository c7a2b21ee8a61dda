"""The port's objective links against the JAX package's, on the CPU.

Every objective a model text can name is loaded into both packages from
the same text; the `objective=` line must write back alike, and
`convert_output` on the same f32 raw scores must be bitwise the
reference's (sigmoid, softmax and exp in XLA's CPU arithmetic,
`ops/xla_math.py`), except `cross_entropy_lambda`'s `log1p`, which must
agree within CONVERTED_MAX_ULP.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402

#: bound on |port - jax| for the one link left inexact, in units in the
#: last place; worst measured here: 3 ulp (cross_entropy_lambda's
#: log1p(exp(s)) with torch's exp, before the port's exp was XLA's)
CONVERTED_MAX_ULP = 4



@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's links run with one intra-op thread here.  With this
    CPU build of torch (2.13.0+cpu, MKL), the first multi-threaded
    `torch.exp` of a few thousand f32 values in a process returns one
    thread's share up to ~1,800 ulp off in about 2% of processes; a
    second call, or one thread, gives the correctly rounded values.
    That is the CPU library's fault, not the link's (the card's path
    does not use it), and it would make this comparison flaky."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


#: (objective= line, extra [param: value] line or "", exact link?)
OBJECTIVES = [
    ("regression", "", True),
    ("regression", "[reg_sqrt: true]", True),
    ("regression_l1", "", True),
    ("huber alpha:0.8", "", True),
    ("fair fair_c:2", "", True),
    ("quantile alpha:0.3", "", True),
    ("mape", "", True),
    ("poisson", "", True),
    ("gamma", "", True),
    ("tweedie tweedie_variance_power:1.2", "", True),
    ("binary sigmoid:0.7", "", True),
    ("multiclassova num_class:3 sigmoid:1.5", "", True),
    ("multiclass num_class:3", "", True),
    ("cross_entropy", "", True),
    ("cross_entropy_lambda", "", False),
    ("lambdarank", "", True),
    ("rank_xendcg", "", True),
]


def _text(objective, param):
    text = (ROOT / "tests" / "data" / "golden_binary.model.txt").read_text()
    text = text.replace("objective=binary sigmoid:1",
                        f"objective={objective}")
    if param:
        text = text.replace("parameters:\n", f"parameters:\n{param}\n", 1)
    return text


@pytest.mark.parametrize("objective,param,exact", OBJECTIVES,
                         ids=[f"{o.split()[0]}{'-' + p[1:-1] if p else ''}"
                              for o, p, _ in OBJECTIVES])
def test_convert_output_matches_jax(objective, param, exact):
    text = _text(objective, param)
    bj = lgb.Booster(model_str=text)
    bp = lt.Booster(model_str=text)
    assert bp.objective_.name == bj.objective_.name
    assert bp.model_to_string() == bj.model_to_string()
    rng = np.random.RandomState(0)
    score = (rng.randn(2000, 3) * 4).astype(np.float32)
    score[:4, 0] = [0.0, -0.0, 30.0, -30.0]
    want = np.asarray(bj.objective_.convert_output(jnp.asarray(score)))
    got = bp.objective_.convert_output(torch.from_numpy(score)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert int(ulp.max()) <= (0 if exact else CONVERTED_MAX_ULP)


def test_custom_objective_has_no_link():
    bp = lt.Booster(model_str=_text("custom", ""))
    assert bp.objective_ is None
    X = np.zeros((2, bp.num_feature()))
    assert np.array_equal(bp.predict(X), bp.predict(X, raw_score=True))
    with pytest.raises(lt.LightGBMError, match="Unknown objective"):
        lt.Booster(model_str=_text("no_such_objective", ""))
