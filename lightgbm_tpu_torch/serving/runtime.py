"""Serving runtime: a ladder of rungs, chosen by the model and the options.

The port's counterpart of `lightgbm_tpu/serving/runtime.py`.  Every
rung answers a request from the same export (`Booster.export_predict_
arrays`); each exact rung is bitwise the JAX package's same rung:

  bounded     opt-in (`precision="bounded"`): exact routing, int8 /
              int16 leaf codes summed in int32 per tile
              (`compiler.quantize.pack_bounded`), f32 scores within the
              bound the runtime publishes (`bounded_bound`): the plan's
              standalone traversal `csrc/traverse.cu`, then the bounded
              sum `csrc/bounded.cu`, whatever the exact rung below it.
  compiled    the compiled tile plan's records through the fused
              `csrc/serve.cu`: one launch a request chunk, then the link.
  device_sum  the stacked-plane traversal `csrc/stacked.cu`, then the
              exact f64 sum `csrc/accumulate.cu`, then the link.
  slot_path   the stacked-plane traversal; the [T, N] slots come back and
              the host gathers and sums the f64 leaf values in boosting
              order (a random forest's division after), then the link.
  host_walk   `tree.py`'s f64 walk (models without stacked planes:
              linear trees).

How a rung is chosen (`refresh`): from the model and the options, never
from a failed kernel.  The exact rung is `compiled` when `compiled` is
not "off" and `build_plan` admits the model; else `device_sum` unless
`device_sum="off"`; else `slot_path`.  A random forest (`average_factor
!= 1`) takes `slot_path`, and a model without stacked planes
`host_walk`.  With `precision="bounded"` the bounded rung sits above it,
unless the model is outside `pack_bounded`'s format, which is counted
(`serve.bounded_disabled{cause=}`) and shown in `status()`.  For one
request, an X narrower than the model's `min_features` (or empty) is
walked on the host (`serve.host_walk{cause=forced}`).  The choice shows
in `rung`, `status()`, the request's `StageClock.rung` and the labelled
counters `serve.rung_selected{rung=,cause=}` and `serve.<rung>`.

What raises instead of falling through.  At `refresh`, each rung is held
to a probe on a threshold-clustered batch: the compiled and device-sum
rungs' raw f64 bits (and converted f32 bits) against the host f64 sum
over the plain traversal's slots, the slot rung's slots against the
plain traversal's, the bounded rung's error against its published bound.
A probe that disagrees, or a kernel that fails to build or launch,
raises `LightGBMError` and nothing is published.  At request time a
launch error, a CUDA error, an injected `serve.dispatch.<rung>` fault or
a watchdog timeout raises `ServingDeviceError` to the caller, counts
`serve.device_errors{rung=}` and opens that rung's breaker; while it is
open, requests fail fast with `ServingUnavailableError`.  No other rung
answers.  After the backoff the next request starts one background
re-probe (the rung's own probe): a pass closes the breaker, an error
doubles the backoff, a content mismatch makes it permanent until
`refresh()`.  This departs from the JAX package, whose lower rungs
answer when a kernel fails (ROADMAP Queue 3 (s)).

Registering the runtime's tensors in a memory ledger waits for ROADMAP
Queue 1 item 5g; the sharded runtime (`serving/sharded.py`) is a
runtime like this one a device.

Rows are independent in every rung, so a padded batch's real rows are
bitwise the unpadded batch's.  Features are cast to f32 on the way in
(huge f64 values saturate to +-inf) and thresholds are f32, as in the
JAX package's device rungs: a row within f32 epsilon of a split
threshold may route differently from the f64 host walk.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..compiler import PlanNotCompilable, build_plan
from ..compiler.kernel import (ROW_BLOCK, DeviceRecords, compiled_predict,
                               compiled_predict_bounded, device_planes)
from ..compiler.quantize import pack_bounded
from ..compiler.records import build_records
from ..ops.predict import (BoundedGroups, bounded_groups,
                           predict_leaf_ensemble,
                           predict_leaf_ensemble_plain,
                           predict_raw_ensemble_exact)
from ..resilience import FAULTS, HALF_OPEN, OPEN, CircuitBreaker, Supervisor
from ..utils.locks import make_lock
from ..utils.log import LightGBMError

#: padding cap: requests above it are chunked, so every device shape is
#: one of log2(4096)+1 = 13 row buckets
DEFAULT_MAX_BATCH_ROWS = 4096

#: per-tile plane budget (`tile_vmem_kb`).  The JAX package's 512 KB is
#: a TPU VMEM figure, above the 227 KB of shared memory an H100 block can
#: use.  Routing bytes do not depend on the tiling; the tile count sets
#: how many blocks the standalone traverse launch has (the fused kernel
#: walks the records, which do not depend on the tiling).  48 KB keeps a
#: tile within the shared memory any block gets without opting in, and
#: it cuts a large model into enough tiles to spread a batch over the
#: card's SMs.
DEFAULT_TILE_KB = 48.0

#: the rungs that run on the device, each with a breaker and a watchdog
DEVICE_RUNGS = ("bounded", "compiled", "device_sum", "slot_path")

_MODES = ("auto", "on", "off")


class ServingDeviceError(LightGBMError):
    """A rung's device dispatch failed (a launch or CUDA error, an
    injected fault, a watchdog timeout); the rung's breaker opened."""


class ServingUnavailableError(LightGBMError):
    """The active rung's breaker is open: the request fails fast."""


def bucket_rows(n: int, max_rows: int = DEFAULT_MAX_BATCH_ROWS) -> int:
    """Smallest power of two >= n, clamped to [1, max_rows]."""
    if n <= 1:
        return 1
    return min(1 << int(n - 1).bit_length(), max_rows)


def _resolve_device(device) -> torch.device:
    """`None` means the GPU.  Without one, only an explicit "cpu" runs
    (the plain versions, for tests); nothing moves to the CPU by
    itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "no CUDA device: ServingRuntime serves on the GPU "
                "(pass device='cpu' to run the plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise LightGBMError(f"unsupported device {dev}")
    return dev


def _mode(name: str, value) -> str:
    v = str(value).lower()
    if v not in _MODES:
        raise ValueError(f"{name} must be one of {_MODES}, got {value!r}")
    return v


class _Tensors(NamedTuple):
    """The tensors a rung reads, on one device (or host copies, after
    `demote`)."""
    stacked: Optional[Dict]            # traversal planes (+ cls)
    value_f64: Optional[torch.Tensor]  # [T, NL] f64 leaf values
    planes: Optional[Tuple]            # plan buckets (words, kids, pal, catw)
    gidx: Optional[torch.Tensor]       # [T] int32 plan row of tree t
    records: Optional[DeviceRecords]   # the fused kernel's records
    qval: Optional[torch.Tensor]       # bounded: [T, NL] int8 / int16
    tile: Optional[torch.Tensor]       # bounded: [T] int32 tile of tree t
    scales: Optional[torch.Tensor]     # bounded: [S] f32
    groups: Optional[BoundedGroups]    # bounded: the trees by (class, tile)

    def _all(self) -> List[torch.Tensor]:
        out = []
        if self.stacked is not None:
            out += list(self.stacked.values())
        for t in (self.value_f64, self.gidx, self.qval, self.tile,
                  self.scales):
            if t is not None:
                out.append(t)
        if self.planes is not None:
            out += [a for bucket in self.planes for a in bucket
                    if a is not None]
        if self.records is not None:
            out += [a for a in (self.records.nodes, self.records.meta,
                                self.records.catw) if a is not None]
        if self.groups is not None:
            out += list(self.groups)
        return out

    def nbytes(self) -> int:
        seen, total = set(), 0
        for t in self._all():
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
        return total

    def to(self, device) -> "_Tensors":
        """A copy with every tensor on `device` (a new copy, also where it
        already lies there, so demoted host copies stay untouched)."""
        def mv(t):
            return None if t is None else t.to(device, copy=True)
        rec = None if self.records is None else self.records._replace(
            nodes=mv(self.records.nodes), meta=mv(self.records.meta),
            catw=mv(self.records.catw))
        return _Tensors(
            None if self.stacked is None else
            {k: mv(v) for k, v in self.stacked.items()},
            mv(self.value_f64),
            None if self.planes is None else
            tuple(tuple(mv(a) for a in b) for b in self.planes),
            mv(self.gidx), rec, mv(self.qval), mv(self.tile),
            mv(self.scales),
            None if self.groups is None else
            BoundedGroups(*(mv(t) for t in self.groups)))


class _ServeState:
    """Everything `predict` reads, published as one reference, so a
    request never mixes an old export with a new plan."""

    __slots__ = ("export", "rung", "exact", "cause", "dev", "plan", "meta",
                 "bound", "measured", "bounded_cause", "demoted")

    def __init__(self, export: Dict):
        self.export = export
        self.rung = "host_walk"      # the rung that answers requests
        self.exact = "host_walk"     # the exact rung (below bounded)
        self.cause = ""              # why `exact` was chosen
        self.dev: Optional[_Tensors] = None
        self.plan = None
        self.meta: Tuple = ()
        self.bound: Optional[float] = None
        self.measured: Optional[float] = None
        self.bounded_cause: Optional[str] = None
        self.demoted = False

    # the compiled rung's tensors, as the fused and unfused programs
    # take them
    @property
    def planes(self):
        return self.dev.planes

    @property
    def gidx(self):
        return self.dev.gidx

    @property
    def records(self):
        return self.dev.records

    @property
    def cls(self):
        return self.dev.stacked.get("cls")

    def clone(self) -> "_ServeState":
        new = _ServeState(self.export)
        for f in self.__slots__:
            setattr(new, f, getattr(self, f))
        return new


class ServingRuntime:
    """Serves one model on `device` (default: the GPU) through the rung
    its model and options select.

    Thread-safe: `predict` reads the published state once per call, and
    `refresh` / `demote` build a complete replacement and publish it in
    one assignment.  Options (the JAX package's names): `compiled` and
    `device_sum` ("auto" = "on", or "off") let a rung be chosen,
    `precision` ("exact" or "bounded") and `quant_bits` (8 or 16) select
    the bounded rung, `tile_vmem_kb` is the planner's per-tile byte
    budget, `dispatch_timeout_ms` the watchdog's deadline a dispatch (0:
    a direct call), `breaker_backoff_s` / `breaker_backoff_max_s` the
    breakers' re-probe backoff and its cap."""

    def __init__(self, booster, *,
                 max_batch_rows: int = DEFAULT_MAX_BATCH_ROWS,
                 start_iteration: int = 0,
                 num_iteration: Optional[int] = None,
                 name: str = "default",
                 device_sum: str = "auto",
                 compiled: str = "auto",
                 tile_vmem_kb: float = DEFAULT_TILE_KB,
                 precision: str = "exact",
                 quant_bits: int = 8,
                 device=None,
                 dispatch_timeout_ms: float = 0.0,
                 breaker_backoff_s: float = 30.0,
                 breaker_backoff_max_s: float = 600.0):
        self._booster = booster
        self.name = name
        self.max_batch_rows = max(int(max_batch_rows), 1)
        self._start = start_iteration
        self._num = num_iteration
        self._device_sum_mode = _mode("device_sum", device_sum)
        self._compiled_mode = _mode("compiled", compiled)
        self._tile_vmem_kb = float(tile_vmem_kb)
        self._precision = str(precision).lower()
        if self._precision not in ("exact", "bounded"):
            raise ValueError(f"serve_precision must be 'exact' or "
                             f"'bounded', got {precision!r}")
        self._quant_bits = int(quant_bits)
        self.device = _resolve_device(device)
        self._supervisors = {r: Supervisor(f"serve.dispatch.{r}",
                                           dispatch_timeout_ms)
                             for r in DEVICE_RUNGS}
        self._breakers = {r: CircuitBreaker(
            f"{name}.{r}", backoff_s=breaker_backoff_s,
            backoff_max_s=breaker_backoff_max_s) for r in DEVICE_RUNGS}
        self._reprobe_lock = make_lock("serving.runtime._reprobe_lock")
        self._reprobe_threads: Dict[str, threading.Thread] = {}
        self._refresh_lock = make_lock("serving.runtime._refresh_lock")
        self._state: Optional[_ServeState] = None
        self._ledger_handles: List = []
        self.refresh()

    # ------------------------------------------------------------ export
    def refresh(self) -> None:
        """(Re-)export the booster, choose the rungs, put their tensors on
        the device and run their probes; publish the result.  Once it is
        published, resets every breaker (the new export's probe has
        re-derived every verdict, the permanent ones too) and re-promotes
        a demoted runtime.  Raises `LightGBMError` when a probe disagrees
        or a kernel fails; nothing is published then, and the breakers
        keep their states: a permanent verdict on the old bytes stands."""
        with self._refresh_lock:
            ex = self._booster.export_predict_arrays(
                self._start, self._num, device=self.device)
            st = self._select(ex)
            if st.rung != "host_walk":
                verdict, detail = self._probe(st.rung, st)
                if verdict != "ok":
                    raise LightGBMError(f"{st.rung} parity probe failed at "
                                        f"refresh: {detail}")
            self._state = st
            self._ledger_register(st)
            for br in self._breakers.values():
                br.reset()
        telemetry.REGISTRY.counter("serve.rung_selected", rung=st.rung,
                                   cause=st.cause).inc()

    def _select(self, ex: Dict) -> _ServeState:
        """The rungs of export `ex` and their tensors (probes not run)."""
        st = _ServeState(ex)
        stacked = ex["stacked"]
        plan = None
        if not ex["trees"]:
            st.exact, st.cause = "host_walk", "no_trees"
        elif stacked is None:
            st.exact, st.cause = "host_walk", "linear_tree"
        elif ex["average_factor"] != 1:
            st.exact, st.cause = "slot_path", "random_forest"
        else:
            if self._compiled_mode != "off":
                try:
                    plan = build_plan(ex, tile_vmem_kb=self._tile_vmem_kb,
                                      name=self.name)
                except PlanNotCompilable as e:
                    telemetry.event("serve.compiled_refused",
                                    model=self.name, detail=str(e)[:200])
                if plan is not None and plan.tile_stats:
                    # the packer's promise that every tile fits
                    # serve_tile_vmem_kb, held to what it packed
                    telemetry.MEMLEDGER.audit(
                        "serve_tile_vmem_kb", self._tile_vmem_kb * 1024,
                        max(int(s.get("bytes", 0))
                            for s in plan.tile_stats),
                        model=self.name, site="serve.compiled_enable",
                        tiles=len(plan.tile_stats))
            if plan is not None:
                st.exact, st.cause = "compiled", "plan"
            elif self._device_sum_mode != "off":
                st.exact = "device_sum"
                st.cause = ("compiled_off" if self._compiled_mode == "off"
                            else "plan_refused")
            else:
                st.exact, st.cause = "slot_path", "device_sum_off"
        st.rung = st.exact
        dev = self.device
        K = ex["num_class"]
        trav = None if stacked is None else {
            k: v for k, v in stacked.items()
            if k not in ("min_features", "value")
            and (k != "cls" or K > 1)}
        fields = dict(stacked=trav, value_f64=None, planes=None, gidx=None,
                      records=None, qval=None, tile=None, scales=None,
                      groups=None)
        if st.exact in ("compiled", "device_sum"):
            fields["value_f64"] = ex["value_f64"]
        packed = None
        if self._precision == "bounded":
            packed, plan = self._pack_bounded(ex, plan, st)
        if st.exact == "compiled" or packed is not None:
            # the compiled and the bounded rung both traverse the plan
            planes, st.meta = device_planes(plan, dev)
            fields.update(planes=planes,
                          gidx=torch.from_numpy(plan.gather_idx).to(dev))
            st.plan = plan
        if st.exact == "compiled":
            cls = trav.get("cls")
            rec = build_records(plan,
                                None if cls is None else cls.cpu().numpy())
            fields["records"] = DeviceRecords.of(rec, dev)
        if packed is not None:
            fields.update(
                qval=torch.from_numpy(packed["qval"]).to(dev),
                tile=torch.from_numpy(packed["tile_of_tree"]).to(dev),
                scales=torch.from_numpy(packed["scales"]).to(dev),
                groups=bounded_groups(packed["tile_of_tree"], K, dev))
            st.bound = float(packed["bound"])
            st.rung = "bounded"
        st.dev = _Tensors(**fields)
        return st

    def _pack_bounded(self, ex: Dict, plan, st: _ServeState):
        """(the bounded planes of `ex`, the plan they are tiled by), or
        (None, plan) with the cause counted (`serve.bounded_disabled
        {cause=}`: "model" for a model without stacked planes or with
        averaging, "format" for one outside the plan's or the
        quantizer's format).  The bounded rung traverses the plan, so it
        is built here when the exact rung did not build it."""
        cause = None
        if ex["stacked"] is None or not ex["trees"] \
                or ex["average_factor"] != 1:
            cause, detail = "model", st.cause
        else:
            try:
                if plan is None:
                    plan = build_plan(ex, tile_vmem_kb=self._tile_vmem_kb,
                                      name=self.name)
                return pack_bounded(ex["trees"], plan, ex["leaf_values"],
                                    ex["num_class"],
                                    bits=self._quant_bits), plan
            except PlanNotCompilable as e:
                cause, detail = "format", str(e)
        st.bounded_cause = cause
        telemetry.REGISTRY.counter("serve.bounded_disabled",
                                   cause=cause).inc()
        telemetry.event("serve.bounded_disabled", model=self.name,
                        cause=cause, detail=detail[:200])
        return None, plan

    # ------------------------------------------------------------- reads
    @property
    def rung(self) -> str:
        """The rung that answers requests."""
        return self._state.rung

    @property
    def compiled_active(self) -> bool:
        """Is the compiled rung answering (plan built, probe passed)?"""
        return self._state.rung == "compiled"

    @property
    def device_sum_active(self) -> bool:
        return self._state.rung == "device_sum"

    @property
    def precision(self) -> str:
        return self._precision

    @property
    def bounded_active(self) -> bool:
        return self._state.rung == "bounded"

    @property
    def bounded_bound(self) -> Optional[float]:
        """The published worst-case |bounded - exact f64| on raw scores
        (None when the bounded rung is not serving)."""
        return self._state.bound

    @property
    def bounded_measured_error(self) -> Optional[float]:
        """The refresh probe's measured max |bounded - exact f64|."""
        return self._state.measured

    @property
    def demoted(self) -> bool:
        return self._state.demoted

    @property
    def num_class(self) -> int:
        return self._state.export["num_class"]

    def num_feature(self) -> int:
        return int(self._booster.num_feature())

    def stale(self) -> bool:
        """Has the booster changed since the last `refresh()`?"""
        return self._state.export["version"] != self._booster._model_version

    def device_bytes(self) -> int:
        """Bytes of this runtime's resident tensors on its device: the
        stacked planes, the f64 leaf values, the plan's planes and
        records, the bounded planes.  0 after `demote()`.  Requests stage
        their rows per call; that copy is transient and not counted."""
        st = self._state
        return 0 if st.demoted or st.dev is None else st.dev.nbytes()

    def breaker_states(self) -> Dict[str, str]:
        return {r: br.state for r, br in self._breakers.items()}

    def status(self) -> Dict:
        """The runtime's choices and health: its rungs and why, the
        precision tier with its published bound and measured error, the
        breakers' states, demotion, staleness, device bytes."""
        st = self._state
        out = {"rung": st.rung, "exact_rung": st.exact, "cause": st.cause,
               "precision": self._precision,
               "breakers": self.breaker_states(), "demoted": st.demoted,
               "stale": self.stale(), "device_bytes": self.device_bytes()}
        if self._precision == "bounded":
            out["bounded"] = {"active": st.rung == "bounded",
                              "bound": st.bound,
                              "measured_max_abs_error": st.measured,
                              "disabled_cause": st.bounded_cause}
        return out

    def buckets(self) -> List[int]:
        """Every padding bucket this runtime can present to the device."""
        out = []
        b = 1
        while b < self.max_batch_rows:
            out.append(b)
            b <<= 1
        out.append(self.max_batch_rows)
        return out

    # ------------------------------------------------------------ demote
    def demote(self) -> int:
        """Move the resident tensors to host copies (the registry's LRU
        budget demotion): the same rung keeps serving, uploading the
        copies each call, byte-identical, until `refresh()` promotes the
        runtime again.  Returns the device bytes freed."""
        with self._refresh_lock:
            cur = self._state
            freed = self.device_bytes()
            if freed == 0:
                return 0
            new = cur.clone()
            new.dev = cur.dev.to("cpu")
            new.demoted = True
            # the booster's caches hold the export's device tensors too
            self._booster._export_cache = None
            self._booster._device_predict_cache = None
            self._state = new
            self._ledger_register(new)
        telemetry.REGISTRY.counter("serve.demotions").inc()
        return freed

    # ------------------------------------------------------------ ledger
    def _ledger_register(self, st: _ServeState) -> None:
        """The published state's device tensors attributed in the memory
        ledger under `serve.<name>.planes{rung=}` (the reference's
        `_ledger_register`): the stacked traversal planes and f64 values,
        the compiled plan's planes and records, the bounded tier's
        planes.  `assign` drops the previous state's handles first; a
        demoted state assigns nothing, which is the release."""
        led = telemetry.MEMLEDGER
        if not led.enabled:
            return
        owner = f"serve.{self.name}.planes"
        groups = {"stacked": [], "compiled": [], "bounded": []}
        d = st.dev
        if d is not None and not st.demoted:
            groups["stacked"] = list((d.stacked or {}).values()) \
                + [d.value_f64]
            groups["compiled"] = [d.gidx] + [
                a for b in (d.planes or ()) for a in b] + (
                [d.records.nodes, d.records.meta, d.records.catw]
                if d.records is not None else [])
            groups["bounded"] = [d.qval, d.tile, d.scales] + list(
                d.groups or ())
        self._ledger_handles = [
            h for rung, arrays in groups.items()
            for h in led.assign(owner, [a for a in arrays if a is not None],
                                rung=rung)]

    def ledger_release(self) -> None:
        """Stop attributing this runtime's planes (an unloaded model),
        handle by handle: a runtime that replaced it under the same name
        keeps its own."""
        for h in self._ledger_handles:
            telemetry.MEMLEDGER.release(h)
        self._ledger_handles = []

    def _tensors(self, st: _ServeState) -> _Tensors:
        """The state's tensors on the device (uploaded for this call when
        the runtime is demoted)."""
        return st.dev.to(self.device) if st.demoted else st.dev

    # ------------------------------------------------------------ probes
    def _probe_batch(self, ex: Dict, rows: int = 256) -> np.ndarray:
        """Deterministic adversarial probe batch: feature values
        clustered at the model's own split thresholds (maximum routing
        and accumulation diversity), NaN/zero sprinkles for the
        missing-value paths, plus plain gaussian noise so large
        exponent gaps and cancellations in the adder all fire."""
        nf = max(self.num_feature(), int(ex["stacked"]["min_features"]), 1)
        rng = np.random.RandomState(0)
        X = rng.randn(rows, nf)
        thr, feats = [], []
        for t in ex["trees"]:
            k = max(t.num_leaves - 1, 0)
            thr.append(np.asarray(t.threshold[:k], np.float64))
            feats.append(np.asarray(t.split_feature[:k], np.int64))
        if thr:
            thr = np.concatenate(thr)
            feats = np.concatenate(feats)
            for f in np.unique(feats):
                v = thr[feats == f]
                pick = v[rng.randint(len(v), size=rows)]
                noise = rng.randn(rows) * (np.std(v) + 1e-3)
                X[:, f] = np.where(rng.rand(rows) < 0.5, pick,
                                   pick + noise)
        X[rng.rand(rows, nf) < 0.03] = np.nan
        X[rng.rand(rows, nf) < 0.03] = 0.0
        return np.ascontiguousarray(X)

    def _probe(self, rung: str, st: _ServeState) -> Tuple[str, str]:
        """Hold `rung` of state `st` to its probe on the probe batch:
        ("ok", ""), ("mismatch", why) for wrong content (for the bounded
        rung: an error above the published bound) or ("error", why) for
        an exception (a kernel that fails to build or launch).  The
        reference is the plain traversal's slots, gathered and summed in
        f64 on the host in boosting order."""
        ex = st.export
        try:
            X = self._probe_batch(ex, rows=min(256, self.max_batch_rows))
            n = X.shape[0]
            dev = self._tensors(st)
            Xd = self._stage32(X, self._chunk_rows(n))
            want_slots = predict_leaf_ensemble_plain(
                dev.stacked, Xd)[:, :n].cpu().numpy()
            want = self._host_sum(want_slots, ex)
            if rung == "slot_path":
                got = predict_leaf_ensemble(dev.stacked, Xd)[:, :n]
                if not np.array_equal(got.cpu().numpy(), want_slots):
                    return "mismatch", "slots differ from the plain " \
                                       "traversal's"
                return "ok", ""
            got = self._dispatch(rung, X, st, want_raw=True)
            if rung == "bounded":
                if got.shape != want.shape:
                    st.measured = float("inf")
                else:
                    st.measured = float(np.max(np.abs(
                        got.astype(np.float64) - want), initial=0.0))
                if not np.isfinite(st.measured) or st.measured > st.bound:
                    return "mismatch", (f"measured error {st.measured!r} "
                                        f"above the published bound "
                                        f"{st.bound!r}")
                return "ok", ""
            if got.shape != want.shape or not np.array_equal(
                    got.view(np.uint64), want.view(np.uint64)):
                return "mismatch", "raw scores differ from the routing " \
                                   "reference's f64 sum"
            if self._booster.objective_ is not None:
                got_c = self._dispatch(rung, X, st, want_raw=False)
                want_c = self._convert(want)
                if got_c.shape != want_c.shape \
                        or got_c.dtype != want_c.dtype \
                        or not np.array_equal(got_c.view(np.uint32),
                                              want_c.view(np.uint32)):
                    return "mismatch", "converted scores differ"
            return "ok", ""
        except Exception as e:  # reported as the probe's verdict
            return "error", f"{type(e).__name__}: {str(e)[:300]}"

    # ------------------------------------------- breaker-gated recovery
    def _maybe_reprobe(self) -> None:
        """Request-path hook: an OPEN breaker whose backoff has elapsed
        goes half-open and starts one background re-probe.  The request
        itself never probes."""
        for rung, br in self._breakers.items():
            if br.state == OPEN and br.begin_probe():
                t = threading.Thread(
                    target=self._reprobe, args=(rung,), daemon=True,
                    name=f"lgbm-serve-reprobe-{self.name}-{rung}")
                with self._reprobe_lock:
                    self._reprobe_threads[rung] = t
                t.start()

    def _reprobe(self, rung: str) -> None:
        """Half-open re-probe against the live state: close, re-open with
        the backoff doubled, or make permanent on a content mismatch."""
        br = self._breakers[rung]
        telemetry.REGISTRY.counter("serve.breaker.reprobe", rung=rung).inc()
        try:
            with self._refresh_lock:
                if br.state != HALF_OPEN:
                    return          # a refresh has reset it meanwhile
                cur = self._state
                if rung != cur.rung:
                    br.record_failure()
                    return
                verdict, detail = self._probe(rung, cur)
        except Exception as e:  # a failed re-probe must never propagate
            verdict, detail = "error", str(e)[:200]
        if verdict == "ok":
            br.record_success()
            telemetry.REGISTRY.counter("serve.breaker.recovered",
                                       rung=rung).inc()
        elif verdict == "mismatch":
            br.record_mismatch()
        else:
            br.record_failure()
        telemetry.event("serve.breaker.reprobe", model=self.name, rung=rung,
                        verdict=verdict, detail=detail[:200])

    def join_reprobes(self, timeout: Optional[float] = None) -> None:
        """Wait for the background re-probes started so far."""
        with self._reprobe_lock:
            threads = list(self._reprobe_threads.values())
        for t in threads:
            t.join(timeout)

    # ----------------------------------------------------------- predict
    def warmup(self) -> int:
        """Run every padding bucket once through the answering rung (raw
        and, with an objective, converted), so the first live request
        pays no kernel build or allocator growth.  Returns the number of
        buckets warmed (0 on the host-walk rung)."""
        st = self._state
        ex = st.export
        if st.rung == "host_walk":
            return 0
        nf = max(self.num_feature(), int(ex["stacked"]["min_features"]))
        sizes = self.buckets()
        with telemetry.span("serve.warmup", model=self.name,
                            buckets=len(sizes)):
            t0 = time.perf_counter()
            for b in sizes:
                Z = np.zeros((b, nf), np.float64)
                self._dispatch(st.rung, Z, st, want_raw=True)
                if self._booster.objective_ is not None:
                    self._dispatch(st.rung, Z, st, want_raw=False)
            telemetry.REGISTRY.timing("serve.warmup").observe(
                time.perf_counter() - t0)
        return len(sizes)

    def predict(self, X, raw_score: bool = False,
                clock: Optional[telemetry.StageClock] = None) -> np.ndarray:
        """Scores for the rows of X from the answering rung: f64 raw sums
        ([N] or [N, K]) with `raw_score` or without an objective, else the
        objective's f32 outputs (the bounded rung: f32 raw scores).
        Requests above `max_batch_rows` are chunked.  Raises
        `ServingDeviceError` when the rung's dispatch fails and
        `ServingUnavailableError` while its breaker is open.

        `clock` collects per-stage wall-clock deltas (staging copy,
        dispatch, copy back; the rest lands in `convert`) and the rung."""
        if clock is None:
            clock = telemetry.StageClock()
        if not (isinstance(X, np.ndarray) and X.dtype == np.float64
                and X.flags["C_CONTIGUOUS"]):
            X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n = X.shape[0]
        st = self._state
        ex = st.export
        self._maybe_reprobe()
        want_raw = raw_score or self._booster.objective_ is None
        with telemetry.span("serve.predict", model=self.name, rows=n):
            t0 = time.perf_counter()
            stacked = ex["stacked"]
            forced = n == 0 or (stacked is not None
                                and X.shape[1] < stacked["min_features"])
            if st.rung == "host_walk" or forced:
                clock.rung = "host_walk"
                telemetry.REGISTRY.counter(
                    "serve.host_walk",
                    cause="forced" if forced else st.cause).inc()
                raw = self._host_walk(X, ex)
                out = raw if want_raw else self._convert(raw)
            else:
                out = self._device(st, X, want_raw, clock)
            total = time.perf_counter() - t0
            telemetry.REGISTRY.timing("serve.predict").observe(total)
            accounted = sum(clock.stages.get(s, 0.0)
                            for s in ("stage_copy", "dispatch", "d2h",
                                      "convert"))
            clock.add("convert", max(total - accounted, 0.0))
        telemetry.REGISTRY.counter("serve.rows").inc(n)
        return out

    def _device(self, st: _ServeState, X: np.ndarray, want_raw: bool,
                clock: telemetry.StageClock) -> np.ndarray:
        """X through the answering device rung, chunk by chunk."""
        rung = st.rung
        clock.rung = rung
        br = self._breakers[rung]
        if not br.allow_request():
            telemetry.REGISTRY.counter("serve.unavailable", rung=rung).inc()
            raise ServingUnavailableError(
                f"serving model {self.name!r}: the {rung} rung's breaker is "
                f"{br.state}; retry later")
        try:
            outs = [self._dispatch(rung, X[lo:lo + self.max_batch_rows], st,
                                   want_raw, clock)
                    for lo in range(0, X.shape[0], self.max_batch_rows)]
        except Exception as e:  # every device failure opens the breaker
            telemetry.REGISTRY.counter("serve.device_errors",
                                       rung=rung).inc()
            br.record_failure()
            telemetry.event("serve.device_error", model=self.name, rung=rung,
                            error=str(e)[:200])
            raise ServingDeviceError(
                f"serving model {self.name!r}: the {rung} rung failed "
                f"({type(e).__name__}: {str(e)[:200]}); its breaker is "
                f"open") from e
        telemetry.REGISTRY.counter(f"serve.{rung}").inc()
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _dispatch(self, rung: str, Xc: np.ndarray, st: _ServeState,
                  want_raw: bool,
                  clock: Optional[telemetry.StageClock] = None
                  ) -> np.ndarray:
        """One chunk (<= max_batch_rows rows) through device rung `rung`,
        under its watchdog: the rung's answer for the chunk's rows."""
        if clock is None:
            clock = telemetry.StageClock()
        ex = st.export
        n = Xc.shape[0]
        t = time.perf_counter()
        Xd = self._stage32(Xc, self._chunk_rows(n))
        clock.add("stage_copy", time.perf_counter() - t)
        K = ex["num_class"]
        conv = None if want_raw or rung == "slot_path" \
            else self._booster.objective_.convert_output

        def device():
            with telemetry.MEMLEDGER.oom_guard(f"serve.dispatch.{rung}",
                                               model=self.name):
                return dispatch()

        def dispatch():
            FAULTS.inject(f"serve.dispatch.{rung}")
            t = time.perf_counter()
            dev = self._tensors(st)
            if rung == "compiled":
                out = compiled_predict(Xd, dev.planes, dev.gidx,
                                       dev.value_f64, dev.stacked.get("cls"),
                                       meta=st.meta, n_class=K,
                                       convert=conv, records=dev.records)
            elif rung == "device_sum":
                out = predict_raw_ensemble_exact(dev.stacked, Xd,
                                                 dev.value_f64, K, conv)
            elif rung == "bounded":
                out = compiled_predict_bounded(
                    Xd, dev.planes, dev.gidx, dev.qval, dev.tile,
                    dev.scales, meta=st.meta, n_class=K, convert=conv,
                    groups=dev.groups)
            else:
                out = predict_leaf_ensemble(dev.stacked, Xd)[:, :n]
            clock.add("dispatch", time.perf_counter() - t)
            t = time.perf_counter()
            o = out.cpu().numpy()
            clock.add("d2h", time.perf_counter() - t)
            telemetry.REGISTRY.counter("serve.d2h_bytes").inc(o.nbytes)
            return FAULTS.inject(f"serve.d2h.{rung}", o)

        out = self._supervisors[rung].call(device)
        if rung != "slot_path":
            return out[:n]
        raw = self._host_sum(out, ex)
        return raw if want_raw else self._convert(raw)

    @staticmethod
    def _host_sum(slots: np.ndarray, ex: Dict) -> np.ndarray:
        """The f64 leaf values of `slots` [T, n] summed on the host, tree
        by tree in boosting order into class t % K (the host walk's
        summation), divided by a random forest's average factor."""
        K = ex["num_class"]
        leaf_values = ex["leaf_values"]
        raw = np.zeros((slots.shape[1], K), np.float64)
        for i in range(slots.shape[0]):
            raw[:, i % K] += leaf_values[i, slots[i]]
        if ex["average_factor"] != 1:
            raw /= ex["average_factor"]
        return raw[:, 0] if K == 1 else raw

    @staticmethod
    def _host_walk(X: np.ndarray, ex: Dict) -> np.ndarray:
        """`tree.py`'s f64 walk of every tree, summed in boosting order."""
        K = ex["num_class"]
        raw = np.zeros((X.shape[0], K), np.float64)
        for i, t in enumerate(ex["trees"]):
            raw[:, i % K] += t.predict(X)
        if ex["average_factor"] != 1:
            raw /= ex["average_factor"]
        return raw[:, 0] if K == 1 else raw

    def _chunk_rows(self, n: int) -> int:
        """Device rows for a chunk of n: its bucket, padded on up to a
        multiple of ROW_BLOCK when an odd cap (max_batch_rows=3000)
        clamps the top bucket to a non-multiple."""
        b = bucket_rows(n, self.max_batch_rows)
        if b > ROW_BLOCK and b % ROW_BLOCK:
            b += ROW_BLOCK - b % ROW_BLOCK
        return b

    def _stage32(self, Xc: np.ndarray, b: int) -> torch.Tensor:
        """`Xc` as f32 rows padded with zeros to `b`, on the device.
        f64 -> f32 saturates huge values to inf, the routing wanted
        (inf lies beyond every threshold and category span); the
        padding rows are sliced away by the callers."""
        buf = np.zeros((b, Xc.shape[1]), np.float32)
        with np.errstate(over="ignore"):
            buf[:Xc.shape[0]] = Xc
        out = torch.from_numpy(buf).to(self.device)
        if out.device.type != "cpu":
            # freed with the request (weakref); host rows are not device
            # memory
            telemetry.MEMLEDGER.register(f"serve.{self.name}.staging", out)
        return out

    def _convert(self, raw: np.ndarray) -> np.ndarray:
        """The objective's link over host f64 raw scores, on the device,
        padded to the same row buckets the device rungs use, so all run
        the link on the same shapes."""
        outs = []
        for lo in range(0, max(raw.shape[0], 1), self.max_batch_rows):
            chunk = raw[lo:lo + self.max_batch_rows]
            n = chunk.shape[0]
            pad = np.zeros((self._chunk_rows(n),) + raw.shape[1:],
                           np.float64)
            pad[:n] = chunk
            t = torch.from_numpy(pad).to(self.device).to(torch.float32)
            outs.append(self._booster.objective_.convert_output(t)[:n]
                        .cpu().numpy())
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
