"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

It trains LightGBM models on an NVIDIA GPU (`train`, `cv`, `Dataset`
from arrays or from CSV, TSV and LibSVM files, in memory or spilled to
an on-disk shard store, the scikit-learn estimators: both growers on
hand-written CUDA histogram and split kernels) and serves them
(`Booster` loads model text, `ServingRuntime` answers requests through
hand-written CUDA kernels, `csrc/`; `Booster.predict(...,
device_predict=True)` runs the batch program on the card), with the
reference's analysis API (`pred_leaf`, `pred_contrib`, the plotting
functions, `convert.py`).  It imports torch and numpy, never
jax and nothing of `lightgbm_tpu`, which stays the reference the port is
tested against.
"""
from .basic import Dataset, Sequence
from .booster import Booster
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .engine import CVBooster, cv, train
# matplotlib and graphviz are imported inside each function that draws
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_split_value_histogram, plot_tree)
from .serving import ServingRuntime
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError

__version__ = "0.2.0"

__all__ = ["Dataset", "Sequence", "Booster", "train", "cv", "CVBooster", "ServingRuntime",
           "LightGBMError", "EarlyStopException", "early_stopping",
           "log_evaluation", "record_evaluation", "reset_parameter",
           "LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker",
           "plot_importance", "plot_metric", "plot_split_value_histogram",
           "plot_tree", "create_tree_digraph"]
