"""Parameter/config system: the JAX package's `utils/config.py`, copied.

The parameter table (`_PARAMS`), the alias maps, `Config`,
`canonical_param_name`, `resolve_objective` and `resolve_metric` are the
reference's own (ref: include/LightGBM/config.h `Config`;
src/io/config.cpp `Config::Set`, `Config::CheckParamConflict`), so both
packages read a params dict the same way.  One value differs:
`device_type` (alias `device`) defaults to "cuda", the port's card;
"cpu" runs the kernels' plain versions, and the booster refuses any
other value.  Parameters that only mean something to the JAX package
(the `tpu_*` knobs, serving, fleet) are accepted here so that one params
dict drives both packages; the training slice refuses the ones it does
not implement, with the reason.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple, Union

from . import log

# name -> (default, type, aliases)
# Types: bool/int/float/str, or list variants ("vec_double", "vec_int", "vec_str").
_PARAMS: Dict[str, Tuple[Any, str, Tuple[str, ...]]] = {
    # ---- core ----
    "config": ("", "str", ("config_file",)),
    "task": ("train", "str", ("task_type",)),
    "objective": ("regression", "str", ("objective_type", "app", "application", "loss")),
    "boosting": ("gbdt", "str", ("boosting_type", "boost")),
    "data_sample_strategy": ("bagging", "str", ()),
    "data": ("", "str", ("train", "train_data", "train_data_file", "data_filename")),
    "valid": ([], "vec_str", ("test", "valid_data", "valid_data_file", "test_data",
                              "test_data_file", "valid_filenames")),
    "num_iterations": (100, "int", ("num_iteration", "n_iter", "num_tree", "num_trees",
                                    "num_round", "num_rounds", "nrounds",
                                    "num_boost_round", "n_estimators", "max_iter")),
    "learning_rate": (0.1, "float", ("shrinkage_rate", "eta")),
    "num_leaves": (31, "int", ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes")),
    "tree_learner": ("serial", "str", ("tree", "tree_type", "tree_learner_type")),
    "num_threads": (0, "int", ("num_thread", "nthread", "nthreads", "n_jobs")),
    "device_type": ("cuda", "str", ("device",)),
    "seed": (None, "int_or_none", ("random_seed", "random_state")),
    "deterministic": (False, "bool", ()),
    # ---- learning control ----
    "force_col_wise": (False, "bool", ()),
    "force_row_wise": (False, "bool", ()),
    "histogram_pool_size": (-1.0, "float", ("hist_pool_size",)),
    "max_depth": (-1, "int", ()),
    "min_data_in_leaf": (20, "int", ("min_data_per_leaf", "min_data", "min_child_samples",
                                     "min_samples_leaf")),
    "min_sum_hessian_in_leaf": (1e-3, "float", ("min_sum_hessian_per_leaf", "min_sum_hessian",
                                                "min_hessian", "min_child_weight")),
    "bagging_fraction": (1.0, "float", ("sub_row", "subsample", "bagging")),
    "pos_bagging_fraction": (1.0, "float", ("pos_sub_row", "pos_subsample", "pos_bagging")),
    "neg_bagging_fraction": (1.0, "float", ("neg_sub_row", "neg_subsample", "neg_bagging")),
    "bagging_freq": (0, "int", ("subsample_freq",)),
    "bagging_seed": (3, "int", ("bagging_fraction_seed",)),
    "feature_fraction": (1.0, "float", ("sub_feature", "colsample_bytree")),
    "feature_fraction_bynode": (1.0, "float", ("sub_feature_bynode", "colsample_bynode")),
    "feature_fraction_seed": (2, "int", ()),
    "extra_trees": (False, "bool", ("extra_tree",)),
    "extra_seed": (6, "int", ()),
    "early_stopping_round": (0, "int", ("early_stopping_rounds", "early_stopping",
                                        "n_iter_no_change")),
    "first_metric_only": (False, "bool", ()),
    "max_delta_step": (0.0, "float", ("max_tree_output", "max_leaf_output")),
    "lambda_l1": (0.0, "float", ("reg_alpha", "l1_regularization")),
    "lambda_l2": (0.0, "float", ("reg_lambda", "lambda", "l2_regularization")),
    "linear_lambda": (0.0, "float", ()),
    "min_gain_to_split": (0.0, "float", ("min_split_gain",)),
    "drop_rate": (0.1, "float", ("rate_drop",)),
    "max_drop": (50, "int", ()),
    "skip_drop": (0.5, "float", ()),
    "xgboost_dart_mode": (False, "bool", ()),
    "uniform_drop": (False, "bool", ()),
    "drop_seed": (4, "int", ()),
    "top_rate": (0.2, "float", ()),
    "other_rate": (0.1, "float", ()),
    "min_data_per_group": (100, "int", ()),
    "max_cat_threshold": (32, "int", ()),
    "cat_l2": (10.0, "float", ()),
    "cat_smooth": (10.0, "float", ()),
    "max_cat_to_onehot": (4, "int", ()),
    "top_k": (20, "int", ("topk",)),
    "monotone_constraints": ([], "vec_int", ("mc", "monotone_constraint", "monotonic_cst")),
    "monotone_constraints_method": ("basic", "str", ("monotone_constraining_method", "mc_method")),
    "monotone_penalty": (0.0, "float", ("monotone_splits_penalty", "ms_penalty", "mc_penalty")),
    "feature_contri": ([], "vec_double", ("feature_contrib", "fc", "fp", "feature_penalty")),
    "forcedsplits_filename": ("", "str", ("fs", "forced_splits_filename", "forced_splits_file",
                                          "forced_splits")),
    "refit_decay_rate": (0.9, "float", ()),
    "cegb_tradeoff": (1.0, "float", ()),
    "cegb_penalty_split": (0.0, "float", ()),
    "cegb_penalty_feature_lazy": ([], "vec_double", ()),
    "cegb_penalty_feature_coupled": ([], "vec_double", ()),
    "path_smooth": (0.0, "float", ()),
    "interaction_constraints": ("", "str", ()),
    "verbosity": (1, "int", ("verbose",)),
    # ---- dataset ----
    "linear_tree": (False, "bool", ("linear_trees",)),
    "max_bin": (255, "int", ("max_bins",)),
    "max_bin_by_feature": ([], "vec_int", ()),
    "min_data_in_bin": (3, "int", ()),
    "bin_construct_sample_cnt": (200000, "int", ("subsample_for_bin",)),
    "data_random_seed": (1, "int", ("data_seed",)),
    "is_enable_sparse": (True, "bool", ("is_sparse", "enable_sparse", "sparse")),
    "enable_bundle": (True, "bool", ("is_enable_bundle", "bundle")),
    "max_conflict_rate": (0.0, "float", ()),
    "use_missing": (True, "bool", ()),
    "zero_as_missing": (False, "bool", ()),
    "feature_pre_filter": (True, "bool", ()),
    "pre_partition": (False, "bool", ("is_pre_partition",)),
    "two_round": (False, "bool", ("two_round_loading", "use_two_round_loading")),
    "external_memory": (False, "bool", ("use_external_memory",)),
    "datastore_dir": ("", "str", ()),
    "datastore_shard_rows": (0, "int", ()),
    "datastore_budget_mb": (64.0, "float", ()),
    "datastore_prefetch": (2, "int", ()),
    # streamed training (lightgbm_tpu/streaming): "auto" streams when the
    # assembled device matrix would exceed datastore_budget_mb; "on"
    # forces streaming (implies external_memory); "off" never streams
    "streaming_train": ("auto", "str", ()),
    # shard read-ahead depth for re-streaming passes; 0 inherits
    # datastore_prefetch
    "streaming_prefetch_depth": (0, "int", ()),
    "header": (False, "bool", ("has_header",)),
    "label_column": ("", "str", ("label",)),
    "weight_column": ("", "str", ("weight",)),
    "group_column": ("", "str", ("group", "group_id", "query_column", "query", "query_id")),
    "ignore_column": ("", "str", ("ignore_feature", "blacklist")),
    "categorical_feature": ("", "str", ("cat_feature", "categorical_column", "cat_column",
                                        "categorical_features")),
    "forcedbins_filename": ("", "str", ()),
    "save_binary": (False, "bool", ("is_save_binary", "is_save_binary_file")),
    "precise_float_parser": (False, "bool", ()),
    "parser_config_file": ("", "str", ()),
    # ---- predict ----
    "start_iteration_predict": (0, "int", ()),
    "num_iteration_predict": (-1, "int", ()),
    "predict_raw_score": (False, "bool", ("is_predict_raw_score", "predict_rawscore",
                                          "raw_score")),
    "predict_leaf_index": (False, "bool", ("is_predict_leaf_index", "leaf_index")),
    "predict_contrib": (False, "bool", ("is_predict_contrib", "contrib")),
    "predict_disable_shape_check": (False, "bool", ()),
    "pred_early_stop": (False, "bool", ()),
    "pred_early_stop_freq": (10, "int", ()),
    "pred_early_stop_margin": (10.0, "float", ()),
    "output_result": ("LightGBM_predict_result.txt", "str",
                      ("predict_result", "prediction_result", "predict_name",
                       "prediction_name", "pred_name", "name_pred")),
    # ---- convert ----
    "convert_model_language": ("", "str", ()),
    "convert_model": ("gbdt_prediction.cpp", "str", ("convert_model_file",)),
    # ---- objective params ----
    "objective_seed": (5, "int", ()),
    "num_class": (1, "int", ("num_classes",)),
    "is_unbalance": (False, "bool", ("unbalance", "unbalanced_sets")),
    "scale_pos_weight": (1.0, "float", ()),
    "sigmoid": (1.0, "float", ()),
    "boost_from_average": (True, "bool", ()),
    "reg_sqrt": (False, "bool", ()),
    "alpha": (0.9, "float", ()),
    "fair_c": (1.0, "float", ()),
    "poisson_max_delta_step": (0.7, "float", ()),
    "tweedie_variance_power": (1.5, "float", ()),
    "lambdarank_truncation_level": (30, "int", ()),
    "lambdarank_norm": (True, "bool", ()),
    "label_gain": ([], "vec_double", ()),
    "lambdarank_position_bias_regularization": (0.0, "float", ()),
    # ---- metric ----
    "metric": ([], "vec_str", ("metrics", "metric_types")),
    "metric_freq": (1, "int", ("output_freq",)),
    "is_provide_training_metric": (False, "bool", ("training_metric", "is_training_metric",
                                                   "train_metric")),
    "eval_at": ([1, 2, 3, 4, 5], "vec_int", ("ndcg_eval_at", "ndcg_at", "map_eval_at", "at")),
    "multi_error_top_k": (1, "int", ()),
    "auc_mu_weights": ([], "vec_double", ()),
    # ---- network ----
    "num_machines": (1, "int", ("num_machine",)),
    # deterministic fixed-order histogram/score reduction for data-parallel
    # training: chains per-shard partial sums in shard order (ring
    # ppermute) instead of psum, so multi-round sharded models are
    # byte-identical to serial; false restores the faster tree-psum
    "deterministic_reduce": (True, "bool", ()),
    "local_listen_port": (12400, "int", ("local_port", "port")),
    "time_out": (120, "int", ()),
    "machine_list_filename": ("", "str", ("machine_list_file", "machine_list", "mlist")),
    "machines": ("", "str", ("workers", "nodes")),
    # ---- GPU (accepted, ignored on TPU) ----
    "gpu_platform_id": (-1, "int", ()),
    "gpu_device_id": (-1, "int", ()),
    "gpu_use_dp": (False, "bool", ()),
    "num_gpu": (1, "int", ()),
    # ---- quantized training (v4) ----
    "use_quantized_grad": (False, "bool", ()),
    "num_grad_quant_bins": (4, "int", ()),
    "quant_train_renew_leaf": (False, "bool", ()),
    "stochastic_rounding": (True, "bool", ()),
    # histogram implementation request (booster._resolve_hist_impl):
    # "auto" picks the fastest eligible path — the int-lattice family
    # (packed on CPU, pallas_q/pallas_fused_q on TPU) is the default
    # wherever the model qualifies, with priced fallback events when the
    # lattice disqualifies.  An explicit value (segment_sum / packed /
    # pallas / pallas_q / pallas_fused / pallas_fused_q) pins the path;
    # an ineligible request degrades to auto with a priced fallback
    # event rather than erroring (degrade-don't-error, like the ladder)
    "hist_impl": ("auto", "str", ()),
    # run Pallas histogram kernels in interpret mode off-TPU (CI/tests:
    # lets an explicit pallas-family hist_impl execute on CPU for
    # byte-identity checks; never needed on a real TPU backend)
    "hist_interpret": (False, "bool", ()),
    # ---- TPU-specific (new; no reference counterpart) ----
    "tpu_row_tile": (0, "int", ()),          # 0 = auto
    # default-on: measured HONESTLY on v5e (2026-07-31, dependency-chained
    # timing — see PROFILE.md round 3b; the round-2 numbers were async
    # artifacts), XLA lowers the 256-segment scatter-add to a serial
    # update loop (~750 ms per 1M x 28 histogram) while the one-hot
    # matmul Pallas kernel runs the same histogram in ~12 ms with BETTER
    # than f32-scatter accuracy (split-bf16 operands, f32 accumulation).
    # Only consulted on TPU backends (CPU keeps segment-sum), and probe-
    # gated so a Mosaic regression degrades to the XLA path
    "tpu_use_pallas": (True, "bool", ()),
    # fused Pallas histogram+split (ops/pallas_hist.py, wave policy
    # only): the wave kernel scans each histogram in VMEM and emits
    # compact split candidates instead of re-reading the [S, F, MB, 3]
    # block from HBM for the XLA scan.  Byte-identical to the unfused
    # kernel by construction and probe-gated on EXACT output equality,
    # so any backend divergence degrades to the base pallas/pallas_q
    # path.  Auto-disabled off the plain numerical gain path (monotone
    # constraints, path smoothing, extra_trees, EFB, distributed)
    "tpu_fused_split": (True, "bool", ("fused_split",)),
    # growth policy (ops/grow_wave.py): "leafwise" = stock-exact strict
    # best-first (ref: serial_tree_learner.cpp Train); "wave" = TPU-first
    # wave-batched best-first — each wave splits every positive-gain
    # frontier leaf and computes all new histograms in ONE full-MXU
    # batched kernel pass (~4-6x fewer histogram passes per tree; tree
    # SHAPE may differ from strict on skewed data, accuracy matches to
    # within noise — see tests/test_wave.py)
    "tree_grow_policy": ("leafwise", "str", ("grow_policy",)),
    # wave policy tuning (ops/grow_wave.py): leaves per batched histogram
    # pass (0 = auto from the MXU LHS capacity / quality sweep,
    # PROFILE.md round 3c), and the depth-bias gain ratio — a ready leaf
    # only splits while its gain >= ratio x the wave's best gain
    # (< 0 = auto)
    "tpu_wave_width": (0, "int", ("wave_width",)),
    "tpu_wave_gain_ratio": (-1.0, "float", ("wave_gain_ratio",)),
    # grow-then-prune: grow to overgrow x num_leaves leaves wave-style,
    # then prune lowest-gain leaf-parent splits back to num_leaves.
    # Opt-in (helps breadth-friendly data; on depth-hungry data the
    # capacity-aware gain floor measured better — PROFILE.md).  < 0 =
    # auto (currently off), <= 1 disables
    "tpu_wave_overgrow": (-1.0, "float", ("wave_overgrow",)),
    "tpu_wave_strict_tail": (-1, "int", ("wave_strict_tail",)),
    # pipelined chunk training (booster.py _dispatch_chunk/_harvest_chunk):
    # max fused chunks in flight at once.  Chunk k+1's score inputs are
    # chunk k's DEVICE-side outputs, so JAX async dispatch runs the next
    # chunk while the host decodes/evaluates the previous one's trees.
    # 1 = serial (dispatch then harvest, the pre-pipeline behavior);
    # models are byte-identical at every depth (tests/test_pipeline.py) —
    # the knob trades transient memory (each in-flight chunk holds its
    # stacked trees + per-iteration score snapshots) for device-idle time
    "tpu_pipeline_chunks": (2, "int", ("pipeline_chunks",)),
    # ---- prediction serving (lightgbm_tpu/serving/) ----
    # micro-batch flush threshold AND the device padding cap: serving
    # requests are padded to power-of-two row buckets <= this, so the
    # shared serving jit compiles at most log2(cap)+1 programs no
    # matter how ragged the request sizes are (tests/test_serving.py
    # asserts the bound via the jax.monitoring recompile listener)
    "serve_max_batch_rows": (4096, "int", ("max_batch_rows",)),
    # how long the batcher holds an open batch waiting for more rows
    # before flushing it (milliseconds)
    "serve_max_wait_ms": (2.0, "float", ("max_wait_ms",)),
    # bounded submit queue: a full queue sheds the request immediately
    # (HTTP 503) instead of queueing unboundedly under overload
    "serve_queue_depth": (256, "int", ("queue_depth",)),
    # per-request deadline: requests still queued past it are shed at
    # flush time.  0 = never shed on age
    "serve_deadline_ms": (0.0, "float", ("deadline_ms",)),
    # compile every padding bucket at model load (warm-up-on-load) so
    # no live request pays a device compile
    "serve_warmup": (True, "bool", ()),
    # device-resident exact accumulation (ops/predict.py
    # predict_raw_ensemble_exact): "auto" enables it per model only
    # after the export-time parity probe bit-matches the host f64
    # reference; "force" skips the probe; "off" pins the slot path
    "serve_device_sum": ("auto", "str", ("device_sum",)),
    # compiled serving rung (lightgbm_tpu/compiler/): quantized
    # tree-tile planes + fused Pallas traverse kernel above the
    # device-sum rung.  "auto" enables it on TPU backends only, after
    # the refresh-time byte-parity probe passes; "on" also allows
    # interpreted CPU execution (still probe-gated); "force" skips the
    # probe; "off" pins the existing ladder
    "serve_compiled": ("auto", "str", ("compiled",)),
    # serving precision tier: "exact" (default) keeps the byte-identical
    # ladder; "bounded" adds an opt-in rung above it serving f32 scores
    # within a per-model PUBLISHED worst-case max-abs-error bound
    # (per-tile int8/int16 quantized leaf values, int32 accumulation —
    # compiler/quantize.pack_bounded).  The refresh-time probe measures
    # the real error against the exact-f64 reference and hard-disables
    # the rung whenever measurement exceeds the published bound; the
    # full exact ladder always remains beneath for fallback
    "serve_precision": ("exact", "str", ("precision",)),
    # bounded-tier quantization width: 8 (int8 codes, ~4x smaller value
    # planes, wider bound) or 16 (int16, tighter bound)
    "serve_quant_bits": (8, "int", ("quant_bits",)),
    # compiler tile budget: the packed planes of one tree tile (node
    # words + threshold palette + categorical bitsets) must fit this
    # many KB (the JAX package's 512 is a TPU VMEM figure; 48 KB is the
    # shared memory an H100 block gets without opting in:
    # serving/runtime.py DEFAULT_TILE_KB)
    "serve_tile_vmem_kb": (48.0, "float", ("tile_vmem_kb",)),
    # co-residency budget for registry exports in MB (stacked traversal
    # planes + leaf-value bit planes); a load over budget demotes LRU
    # entries to host copies and, still over, is rejected with a clear
    # error.  0 = unlimited
    "serve_vram_budget_mb": (0.0, "float", ("vram_budget_mb",)),
    # re-export a stale runtime (booster mutated since load) on the
    # next predict instead of only reporting it via /healthz
    "serve_auto_refresh": (False, "bool", ("auto_refresh",)),
    # HTTP frontend bind address (python -m lightgbm_tpu serve)
    "serve_host": ("127.0.0.1", "str", ()),
    "serve_port": (8080, "int", ()),
    # serving flight recorder (telemetry.SERVE_RECORDER): tail-sample
    # completed request traces into a bounded ring served at
    # /debug/requests.  Per-stage serve.stage.* histograms stay on
    # either way — this gates only the per-request ring
    "serve_trace": (True, "bool", ()),
    # ring capacity (completed traces kept, newest win)
    "serve_trace_ring": (256, "int", ()),
    # latency tail threshold: any request with e2e >= this many ms is
    # recorded (sheds/errors/host-walk fallbacks are always recorded)
    "serve_trace_slow_ms": (100.0, "float", ()),
    # deterministic 1-in-N sampling of healthy requests, so the ring
    # shows what normal looks like next to the tail
    "serve_trace_sample": (64, "int", ()),
    # sharded serving (serving/sharded.py): replicate the exported model
    # onto this many mesh devices and stripe flushed micro-batches over
    # the replicas with a least-outstanding-work scheduler.  0 = all
    # visible devices, 1 = the single-device runtime (default)
    "serve_shard_devices": (1, "int", ("shard_devices",)),
    # ---- resilience plane (lightgbm_tpu/resilience/) ----
    # watchdog deadline for every device dispatch in the serving ladder
    # (compiled / device_sum / slot_path): a dispatch that exceeds this
    # raises DeviceTimeoutError, which the fallback ladder absorbs like
    # any device error.  0 disables supervision (direct call)
    "serve_dispatch_timeout_ms": (0.0, "float", ()),
    # circuit breaker (resilience/breaker.py): initial re-probe backoff
    # after a rung opens, and the exponential-backoff cap
    "serve_breaker_backoff_s": (30.0, "float", ()),
    "serve_breaker_backoff_max_s": (600.0, "float", ()),
    # HTTP frontend request-body cap (MiB): a Content-Length above this
    # is rejected with 413 before the body is read
    "serve_max_body_mb": (32.0, "float", ()),
    # fault-injection plane (resilience/faults.py): arm injection sites
    # at load, e.g. "serve.dispatch.*:hang@p=0.1;prefetch.read:error".
    # Test/chaos-CI surface — empty (default) means zero overhead
    "fault_spec": ("", "str", ()),
    # watchdog deadline for mesh collectives (mesh/placement.py
    # device_put fan-out); 0 disables
    "mesh_collective_timeout_ms": (0.0, "float", ()),
    # ---- continuous-training fleet (lightgbm_tpu/fleet/) ----
    # trainer daemon (fleet/daemon.py): continue the live booster via
    # init_model once this many NEW rows have landed in the tailed
    # append-only datastore
    "fleet_retrain_rows": (1024, "int", ()),
    # boosting rounds added per continuation
    "fleet_rounds": (10, "int", ()),
    # daemon manifest-poll interval (milliseconds)
    "fleet_poll_ms": (200.0, "float", ()),
    # hard cap on retrains before the daemon loop exits (CI smokes /
    # bounded canaries); 0 = run until stopped
    "fleet_max_retrains": (0, "int", ()),
    # shadow gate (fleet/shadow.py): candidate holdout loss may exceed
    # the live model's by at most this relative fraction
    "fleet_gate_tolerance": (0.05, "float", ()),
    # shadow gate: relative mean-|delta| prediction shift allowed on
    # sampled live traffic (0 disables the traffic-shift check)
    "fleet_gate_max_shift": (0.5, "float", ()),
    # holdout tail rows (newest datastore rows) scored by the metric gate
    "fleet_shadow_rows": (512, "int", ()),
    # watchdog deadline for one shadow-gate evaluation: a hung gate
    # fails CLOSED (candidate rejected, live model keeps serving).
    # 0 disables supervision
    "fleet_gate_timeout_ms": (0.0, "float", ()),
    # live-traffic reservoir capacity (rows) the registry sampler keeps
    # for the gate's traffic-shift check
    "fleet_sample_ring": (256, "int", ()),
    # multi-tenant SLO classes (fleet/tenancy.py), best class first:
    # "name=p99_ms,..." — a tenant's observed p99 above its class budget
    # marks it over-SLO for admission control
    "fleet_slo_classes": ("gold=10,silver=50,bronze=250", "str", ()),
    # admission control: queue-pressure fraction (serve.queue_depth /
    # serve_queue_depth) above which over-SLO tenants are shed; worse
    # classes shed at proportionally lower pressure.  0 disables
    "fleet_admission_pressure": (0.5, "float", ()),
    # replica autoscaling for sharded serving, driven by the
    # serve.replica.*.latency histograms + stripe-imbalance gauge
    "fleet_autoscale": (False, "bool", ()),
    "fleet_min_replicas": (1, "int", ()),
    # 0 = up to all visible devices
    "fleet_max_replicas": (0, "int", ()),
    # scale-up only while stripes stay balanced (capacity-bound, not
    # skew-bound): max/mean cumulative stripe ratio allowed
    "fleet_autoscale_imbalance": (1.5, "float", ()),
    # tenant SLO error budget (telemetry/slo.py): availability target —
    # at most (1 - target) of a tenant's requests may exceed its class
    # p99 budget; burn rate 1.0 means errors arrive exactly at that
    # allowed rate
    "fleet_slo_target": (0.99, "float", ()),
    # burn-rate windows (seconds): fast = paging signal, slow = ticket
    # signal + the budget_remaining gauge's horizon
    "fleet_slo_window_fast_s": (60.0, "float", ()),
    "fleet_slo_window_slow_s": (600.0, "float", ()),
    # model-lineage ledger (telemetry/ledger.py): in-memory record-ring
    # capacity (records also stream to the telemetry_sink when attached)
    "fleet_ledger_ring": (1024, "int", ()),
    # feature-drift monitor (fleet/drift.py): PSI of sampled serving
    # traffic vs the training bin distribution, computed off the hot
    # path from the trainer daemon's poll loop.  Opt-in
    "serve_drift": (False, "bool", ()),
    # sampled-row ring capacity / minimum window before a PSI compute /
    # top-k drifting features exported as serve.drift.psi{feature=}
    "serve_drift_ring": (512, "int", ()),
    "serve_drift_min_rows": (64, "int", ()),
    "serve_drift_top_k": (5, "int", ()),
    # production soak harness (lightgbm_tpu/soak/): closed-loop
    # multi-tenant traffic + chaos scenarios + capacity probing over the
    # composed fleet/serving plane.  Orchestration knobs only — the
    # harness inherits the fleet_*/serve_* params above for everything
    # else.  Synthetic tenants cycle through the fleet_slo_classes
    # ranks; tenant t0 is the trainer daemon's (hot-swapped) model
    "soak_tenants": (2, "int", ()),
    # per-tenant target request rate.  Closed-loop with pacing: each
    # tenant's workers never exceed the schedule, and under
    # back-pressure they fall behind instead of queueing unboundedly
    "soak_qps": (25.0, "float", ()),
    # closed-loop workers per tenant (the in-flight concurrency cap)
    "soak_concurrency": (2, "int", ()),
    # master seed: request content is a pure function of
    # (seed, tenant, slot index, drift epoch) — thread interleaving
    # never changes WHAT is sent, only when
    "soak_seed": (0, "int", ()),
    # distinct request blocks per tenant; the byte-consistency oracle
    # memoizes one reference prediction per live model version x block
    # x flavor, which is what keeps the oracle O(versions), not O(requests)
    "soak_pool_blocks": (8, "int", ()),
    # request batch-row palette, cycled across the block pool (mixed
    # widths exercise the batcher's width-grouped coalescing)
    "soak_block_rows": ("1,8,64", "str", ()),
    # drive the stdlib HTTP frontend (full wire round-trip; JSON floats
    # parse back bit-exact) instead of the in-process registry surface
    "soak_http": (True, "bool", ()),
    # default scenario horizon (seconds) when the scenario file has no
    # `end` event and the CLI passes no --minutes
    "soak_seconds": (30.0, "float", ()),
    # capacity prober (soak/capacity.py): seconds per load step,
    # aggregate starting QPS, per-step multiplier, and the step cap
    "soak_capacity_step_s": (3.0, "float", ()),
    "soak_capacity_start_qps": (16.0, "float", ()),
    "soak_capacity_factor": (1.6, "float", ()),
    "soak_capacity_max_steps": (8, "int", ()),
    # multi-slice training: shard rows over a 2-level ("dcn", "ici") mesh
    # with this many slices (1 = flat single-slice mesh)
    "tpu_dcn_slices": (1, "int", ()),
    "tpu_num_shards": (0, "int", ()),        # 0 = all visible devices
    # explicit mesh topology for the distributed learners, overriding
    # num_machines/tpu_num_shards/tpu_dcn_slices: "N" builds a 1-D data
    # mesh over N devices, "DxI" a 2-level ("dcn", "ici") mesh
    # (mesh/topology.py parse_mesh_shape).  Empty/"auto" = derive from
    # the other params
    "mesh_shape": ("", "str", ()),
    # debug mode: enable jax_debug_nans so any NaN/Inf produced inside the
    # jitted training step raises FloatingPointError at the offending op
    # (our analog of the reference's USE_SANITIZER builds,
    # ref: cmake/Sanitizer.cmake — TPU/XLA is functional so memory races
    # can't happen; numeric poison is the failure class that remains)
    "tpu_debug_nans": (False, "bool", ()),
    # debug mode: enable runtime @contract shape/dtype checking on the
    # ops/ entry points (lightgbm_tpu/analysis/contracts.py).  Checks run
    # at trace time (once per compilation, not per step) but the flag is
    # process-global and sticky — see analysis.enable_runtime_checks
    "debug_contracts": (False, "bool", ()),
    # debug mode: arm the runtime lock-order witness
    # (lightgbm_tpu/analysis/lockwitness.py).  Every subsystem lock
    # created via make_lock records the global acquisition order; the
    # first acquisition that inverts an already-observed order raises
    # LockOrderError with both stacks instead of (maybe) deadlocking.
    # Process-global and sticky, like debug_contracts.  Purely
    # order-observing: model bytes and serving responses are identical
    # with it on or off
    "debug_locks": (False, "bool", ()),
    # telemetry (lightgbm_tpu/telemetry/): JSONL event sink path — spans
    # (dataset bin, compile/warmup, train chunks, eval, predict), point
    # events (probe attempts, fallbacks) and a final metrics snapshot are
    # appended there; summarize with `python -m lightgbm_tpu
    # telemetry-report <path>`.  Empty = no sink, near-zero overhead
    "telemetry_sink": ("", "str", ()),
    # Prometheus text-exposition dump of the metrics registry, written at
    # the end of engine.train() (node-exporter textfile collector format)
    "telemetry_prometheus": ("", "str", ()),
    # cross-process telemetry spool (telemetry/spool.py): when enabled,
    # this process appends its event stream into the shared spool
    # directory as proc-<host>-<pid>-<rank>.jsonl with a clock-anchor
    # header; merge with `python -m lightgbm_tpu timeline <dir>`.
    # telemetry_spool=true with an empty dir uses ./lgbm_tpu_spool;
    # setting telemetry_spool_dir implies telemetry_spool
    "telemetry_spool": (False, "bool", ()),
    "telemetry_spool_dir": ("", "str", ()),
    # training flight recorder (telemetry/recorder.py): opt-in ring-
    # buffered per-round diagnostics — tree depth/leaf counts, split-gain
    # quantiles, top split features, grad/hess aggregates, fallback
    # events, per-phase wall-clock and compile/memory watermarks —
    # emitted as `train.round` events and summarized by
    # `booster.flight_summary()`.  Off (default): zero per-round work,
    # byte-identical models either way (tests/test_flight_recorder.py)
    "flight_recorder": (False, "bool", ()),
    # ring size: how many most-recent rounds flight_summary() aggregates
    "flight_recorder_depth": (128, "int", ()),
    # device-memory ledger (telemetry/memledger.py): attributed per-
    # device HBM accounting — owner-tagged gauges (mem.dev<i>.<owner>),
    # budget-contract auditing, the leak sentinel and OOM forensics.
    # Weakref-tracked and sync-free: models and predictions are byte-
    # identical with it on or off (tests/test_memledger.py)
    "memory_ledger": (True, "bool", ()),
    # background reconcile cadence vs allocator truth (publishes
    # mem.unattributed_bytes); 0 = only on demand (/debug/memory, CLI)
    "memory_reconcile_ms": (0.0, "float", ()),
    # perf-regression sentinel tolerances (`telemetry diff`, run by
    # scripts/run_ci.sh against telemetry_baseline.json): relative
    # tolerance for counter/shape metrics and for wall-clock metrics.
    # Embedded in snapshots written by scripts/telemetry_snapshot.py so a
    # baseline carries its own comparison contract
    "telemetry_diff_rel_tol": (0.25, "float", ()),
    "telemetry_diff_timing_rel_tol": (1.5, "float", ()),
    "saved_feature_importance_type": (0, "int", ()),
    "snapshot_freq": (-1, "int", ("save_period",)),
    "output_model": ("LightGBM_model.txt", "str", ("model_output", "model_out")),
    "input_model": ("", "str", ("model_input", "model_in")),
}

# Build alias -> canonical map.
_ALIASES: Dict[str, str] = {}
for _name, (_d, _t, _al) in _PARAMS.items():
    _ALIASES[_name] = _name
    for _a in _al:
        _ALIASES[_a] = _name

_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "custom": "custom", "none": "custom", "null": "custom", "na": "custom",
}

_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2",
    "regression": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile", "mape": "mape", "mean_absolute_percentage_error": "mape",
    "huber": "huber", "fair": "fair", "poisson": "poisson", "gamma": "gamma",
    "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg", "xendcg": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc", "average_precision": "average_precision",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc_mu": "auc_mu",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "none": "", "na": "", "null": "", "custom": "",
}


def _coerce(value: Any, typ: str, name: str) -> Any:
    if typ == "bool":
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        if isinstance(value, str):
            return value.lower() in ("true", "1", "+", "yes")
        return bool(value)
    if typ == "int":
        return int(value)
    if typ == "int_or_none":
        return None if value is None else int(value)
    if typ == "float":
        return float(value)
    if typ == "str":
        return str(value)
    if typ in ("vec_double", "vec_int", "vec_str"):
        elem = {"vec_double": float, "vec_int": int, "vec_str": str}[typ]
        if isinstance(value, str):
            value = [v for v in value.replace(" ", ",").split(",") if v != ""]
        if not isinstance(value, (list, tuple)):
            value = [value]
        return [elem(v) for v in value]
    raise ValueError(f"unknown param type {typ} for {name}")


class Config:
    """Typed parameter holder with LightGBM alias resolution.

    ``Config(params_dict)`` resolves aliases (first-written wins for the
    canonical name, matching `Config::GetMembersOfAllAlias` precedence of the
    canonical name over aliases), coerces types, and runs conflict checks
    (ref: src/io/config.cpp `Config::CheckParamConflict`).
    """

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        for name, (default, _typ, _al) in _PARAMS.items():
            setattr(self, name, copy.copy(default))
        self.raw_params: Dict[str, Any] = {}
        self.unknown_params: Dict[str, Any] = {}
        if params:
            self.update(params)

    def update(self, params: Dict[str, Any]) -> None:
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            if value is None and key not in ("seed",):
                continue
            canonical = _ALIASES.get(key)
            if canonical is None:
                self.unknown_params[key] = value
                log.warning(f"Unknown parameter: {key}")
                continue
            # canonical name literally present wins over aliases
            if canonical in resolved and canonical in params and key != canonical:
                continue
            resolved[canonical] = value
        for name, value in resolved.items():
            _d, typ, _a = _PARAMS[name]
            setattr(self, name, _coerce(value, typ, name))
        self.raw_params.update(params)
        self._explicit = getattr(self, "_explicit", set()) | set(resolved)
        self._check_param_conflict()

    def _check_param_conflict(self) -> None:
        obj = _OBJECTIVE_ALIASES.get(str(self.objective), self.objective)
        self.objective = obj
        self.metric = [_METRIC_ALIASES.get(m, m) for m in self.metric if
                       _METRIC_ALIASES.get(m, m) != ""]
        if obj in ("multiclass", "multiclassova") and self.num_class <= 1:
            log.fatal("Number of classes should be specified and greater than 1 "
                      "for multiclass training")
        if obj not in ("multiclass", "multiclassova") and self.num_class != 1 and \
                obj != "custom":
            log.fatal(f"Number of classes must be 1 for non-multiclass training, "
                      f"got num_class={self.num_class} objective={obj}")
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the same time")
        if self.bagging_freq > 0 and (self.pos_bagging_fraction < 1.0 or
                                      self.neg_bagging_fraction < 1.0):
            if obj != "binary":
                log.fatal("Unbalanced bagging is only available for binary objective")
        if self.max_depth > 0:
            full = 1 << min(self.max_depth, 30)
            if self.num_leaves > full:
                self.num_leaves = full
        if self.num_leaves < 2:
            self.num_leaves = 2
        if self.seed is not None:
            # derived seeds, same derivation idea as Config::Set in config.cpp;
            # explicitly-passed component seeds win over the derived ones
            explicit = getattr(self, "_explicit", set())
            for offset, name in ((1, "data_random_seed"), (2, "bagging_seed"),
                                 (4, "drop_seed"), (5, "feature_fraction_seed"),
                                 (6, "extra_seed"), (7, "objective_seed")):
                if name not in explicit:
                    setattr(self, name, self.seed + offset)
        log.set_verbosity(self.verbosity)

    def default_metric(self) -> List[str]:
        """Metric implied by the objective when none is given
        (ref: objective `DefaultEvalAt`/metric factory convention)."""
        obj = self.objective
        implied = {
            "regression": ["l2"], "regression_l1": ["l1"], "huber": ["huber"],
            "fair": ["fair"], "poisson": ["poisson"], "quantile": ["quantile"],
            "mape": ["mape"], "gamma": ["gamma"], "tweedie": ["tweedie"],
            "binary": ["binary_logloss"],
            "multiclass": ["multi_logloss"], "multiclassova": ["multi_logloss"],
            "cross_entropy": ["cross_entropy"],
            "cross_entropy_lambda": ["cross_entropy_lambda"],
            "lambdarank": ["ndcg"], "rank_xendcg": ["ndcg"],
        }
        return implied.get(obj, [])

    def to_dict(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in _PARAMS}


def canonical_param_name(name: str) -> Optional[str]:
    return _ALIASES.get(name)


def resolve_objective(name: str) -> str:
    return _OBJECTIVE_ALIASES.get(name, name)


def resolve_metric(name: str) -> str:
    return _METRIC_ALIASES.get(name, name)
