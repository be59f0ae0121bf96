"""Backend selection policies — counterpart of :mod:`repro.core.selector`,
the "selected at runtime" half of the paper.

Three policies, in increasing sophistication:

* :class:`FixedPolicy` — a preference list (optionally per op / per node),
  first supported backend wins.  Orpheus's manual runtime switch.
* :class:`CostModelPolicy` — analytic roofline estimate per backend (the
  op's cost model over a :class:`HardwareProfile`), argmin of estimated
  time.  The default profile is :data:`H100_SXM`.
* :class:`AutotunePolicy` — measure every supported backend on the node's
  actual shapes (warmed once, min of ``reps``, synchronised on the card)
  and pick the fastest; results are cached by (op, backend, shape
  signature), in memory and optionally in a JSON file keyed by
  :func:`hardware_fingerprint`.  The paper's core workflow: comparing layer
  implementations in one environment, per layer and per workload.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import tempfile
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.ir import Node, TensorSpec
from repro_torch.core.registry import Cost, backends_for, get_impl

__all__ = [
    "BackendPolicy",
    "FixedPolicy",
    "CostModelPolicy",
    "AutotunePolicy",
    "HardwareProfile",
    "H100_SXM",
    "HOST_CPU",
    "hardware_fingerprint",
    "default_cache_path",
]


@dataclass(frozen=True)
class HardwareProfile:
    """Peak throughput profile used by the analytic selector, with a
    per-backend efficiency de-rating (fraction of peak each backend is
    expected to sustain).  The table is ``repro``'s, keyed by the port's
    backend names: ``cuda`` in the slot of ``pallas``, ``cuda_split`` of
    ``pallas_split``, ``torch`` of ``xla``."""

    name: str
    peak_flops: float            # FLOP/s
    hbm_bw: float                # B/s
    backend_efficiency: Tuple[Tuple[str, float], ...] = (
        ("cuda", 0.8), ("cuda_split", 0.75), ("torch", 0.65),
        ("winograd", 0.65), ("ref", 0.35),
    )

    def efficiency(self, backend: str) -> float:
        for b, e in self.backend_efficiency:
            if b == backend:
                return e
        return 0.5

    def est_seconds(self, backend: str, cost: Cost) -> float:
        eff = self.efficiency(backend)
        return max(cost.flops / (self.peak_flops * eff),
                   cost.bytes / (self.hbm_bw * eff))


# One NVIDIA H100 SXM (NVIDIA's data sheet: 67 TFLOP/s fp32 outside the
# tensor cores, every kernel of the port being fp32 FFMA; 3.35 TB/s HBM3)
# and a nominal host CPU.
H100_SXM = HardwareProfile("h100-sxm", peak_flops=67e12, hbm_bw=3.35e12)
HOST_CPU = HardwareProfile("host-cpu", peak_flops=5e10, hbm_bw=2e10)


class BackendPolicy:
    """Base: always ``ref``."""

    def choose(self, node: Node, in_specs: Sequence[TensorSpec]) -> str:
        avail = backends_for(node.op, in_specs, node.attrs)
        if not avail:
            raise ValueError(f"no supported backend for {node.op} {in_specs}")
        return "ref" if "ref" in avail else avail[0]

    def resolve(self, node: Node, in_specs: Sequence[TensorSpec]) -> str:
        """A per-node explicit ``backend`` pin always wins."""
        if node.backend is not None:
            avail = backends_for(node.op, in_specs, node.attrs)
            if node.backend not in avail:
                raise ValueError(
                    f"node {node.name}: pinned backend {node.backend!r} not "
                    f"supported here (available: {avail})")
            return node.backend
        return self.choose(node, in_specs)


@dataclass
class FixedPolicy(BackendPolicy):
    """Preference-ordered selection. ``prefer`` is global; ``per_op`` and
    ``per_node`` override it for specific ops / node names.  The default
    ``("cuda", "ref")`` is the port's counterpart of ``repro``'s
    ``("xla", "ref")`` plus the kernel slot that ``pallas`` fills there;
    it never picks ``cuda_split`` or ``torch`` unless asked."""

    prefer: Sequence[str] = ("cuda", "ref")
    per_op: Dict[str, Sequence[str]] = field(default_factory=dict)
    per_node: Dict[str, Sequence[str]] = field(default_factory=dict)

    def choose(self, node: Node, in_specs: Sequence[TensorSpec]) -> str:
        avail = backends_for(node.op, in_specs, node.attrs)
        for pref in (self.per_node.get(node.name), self.per_op.get(node.op),
                     self.prefer):
            if not pref:
                continue
            for b in pref:
                if b in avail:
                    return b
        if avail:
            return avail[0]
        raise ValueError(f"no supported backend for {node.op}")


@dataclass
class CostModelPolicy(BackendPolicy):
    """Analytic argmin over supported backends (no execution needed)."""

    profile: HardwareProfile = H100_SXM

    def choose(self, node: Node, in_specs: Sequence[TensorSpec]) -> str:
        avail = backends_for(node.op, in_specs, node.attrs)
        if not avail:
            raise ValueError(f"no supported backend for {node.op}")
        best, best_t = None, float("inf")
        for b in avail:
            cost = get_impl(node.op, b).cost(in_specs, node.attrs)
            t = self.profile.est_seconds(b, cost)
            if t < best_t:
                best, best_t = b, t
        return best  # type: ignore[return-value]

    def estimate(self, node: Node, in_specs: Sequence[TensorSpec]) -> Dict[str, float]:
        return {b: self.profile.est_seconds(
                    b, get_impl(node.op, b).cost(in_specs, node.attrs))
                for b in backends_for(node.op, in_specs, node.attrs)}


def _spec_sig(specs: Sequence[TensorSpec], attrs: Dict[str, Any]) -> Tuple:
    def freeze(x):
        if isinstance(x, dict):
            return tuple(sorted((k, freeze(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return tuple(freeze(v) for v in x)
        if isinstance(x, np.ndarray):
            return ("nd", x.shape, str(x.dtype))
        return x

    return (tuple((s.shape, s.dtype) for s in specs), freeze(attrs))


def _sig_key(op: str, specs: Sequence[TensorSpec], attrs: Dict[str, Any]) -> str:
    """Stable string key for (op, shapes, attrs) — JSON-dict friendly."""
    return json.dumps([op, _spec_sig(specs, attrs)], sort_keys=True, default=str)


def hardware_fingerprint(device: DeviceLike = None) -> str:
    """Identifies the machine and device a measurement is valid on:
    timings cached under one fingerprint are never reused on other
    hardware.  ``device`` is where the timings are taken (``None`` means
    ``"cuda"``); a card contributes its name and compute capability, and
    torch's version and CUDA version always count."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        major, minor = torch.cuda.get_device_capability(idx)
        dev_sig = f"cuda/{torch.cuda.get_device_name(idx)}/sm_{major}{minor}"
    elif dev.type == "cuda":
        dev_sig = "cuda/none"
    else:
        dev_sig = dev.type
    raw = "|".join([platform.machine(), platform.system(), dev_sig, str(os.cpu_count()),
                    torch.__version__, str(torch.version.cuda)])
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def default_cache_path() -> str:
    """Where the port persists autotune results by default: a file of its
    own beside the JAX package's, so the two never rewrite one file
    (override with ORPHEUS_AUTOTUNE_CACHE)."""
    env = os.environ.get("ORPHEUS_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "orpheus",
                        "autotune_repro_torch.json")


_CACHE_VERSION = 1


@dataclass
class AutotunePolicy(BackendPolicy):
    """Measure-and-pick (the paper's consistent-environment comparison).

    Each candidate impl runs on random inputs matching the node's specs on
    ``device`` (``None`` means ``"cuda"``), warmed once, then timed ``reps``
    times with the device synchronised before and after each rep; the min
    is recorded.  The in-memory cache makes repeated compiles of the same
    network free; with ``cache_path`` set, measurements persist as JSON
    across processes (keyed by op/backend/shape signature under a hardware
    fingerprint), so a second compile of the same model on the same
    machine performs zero re-measurements.

    A backend that raises ``NotImplementedError`` (it cannot run here, see
    :mod:`repro_torch.core.registry`) is recorded as ``inf`` and not retried
    on every compile.  Any other exception propagates: a kernel that fails
    to build, load or launch is never passed over for its plain version.
    (``repro`` records ``inf`` for any exception.)
    """

    reps: int = 5
    candidates: Optional[Sequence[str]] = None  # None = all supported
    cache_path: Optional[str] = None
    device: DeviceLike = None
    _cache: Dict[str, str] = field(default_factory=dict)
    _timings: Dict[str, Dict[str, float]] = field(default_factory=dict)
    n_measured: int = 0   # signatures actually benchmarked by this instance
    n_loaded: int = 0     # signatures preloaded from the on-disk cache
    # (mtime, size) of the cache file after our last write + its content,
    # so repeated saves skip re-parsing a file nobody else touched
    _disk_state: Optional[Tuple[Tuple[float, int], Dict[str, Any]]] = None

    def __post_init__(self) -> None:
        if self.cache_path:
            self._load_cache()

    # -------------------------- persistence --------------------------- #
    def _load_cache(self) -> None:
        """Best-effort preload: a corrupted, truncated or wrong-shaped
        cache file degrades to in-memory tuning instead of failing the
        compile (the file is rewritten cleanly on the next measurement)."""
        try:
            with open(self.cache_path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(data, dict) or data.get("version") != _CACHE_VERSION:
            return
        fps = data.get("fingerprints")
        entries = (fps.get(hardware_fingerprint(self.device))
                   if isinstance(fps, dict) else None)
        if not isinstance(entries, dict):
            return
        for key, times in entries.items():
            if key in self._timings or not isinstance(times, dict):
                continue
            try:
                self._timings[key] = {b: float(t) for b, t in times.items()}
            except (TypeError, ValueError):
                continue
            self.n_loaded += 1

    def _save_cache(self) -> None:
        """Best-effort persist: an unwritable cache location degrades to
        in-memory-only tuning instead of failing the compile."""
        path = self.cache_path
        # merge with whatever is on disk (other processes / fingerprints),
        # skipping the re-read when nobody else has written since our save
        data: Dict[str, Any] = {"version": _CACHE_VERSION, "fingerprints": {}}
        try:
            stamp = (os.path.getmtime(path), os.path.getsize(path))
        except OSError:
            stamp = None
        if self._disk_state is not None and stamp == self._disk_state[0]:
            data = self._disk_state[1]
        elif stamp is not None:
            try:
                with open(path) as f:
                    prev = json.load(f)
                if isinstance(prev, dict) and prev.get("version") == _CACHE_VERSION:
                    data = prev
            except (OSError, ValueError):
                pass
        fp = hardware_fingerprint(self.device)
        if not isinstance(data.get("fingerprints"), dict):
            data["fingerprints"] = {}
        if not isinstance(data["fingerprints"].get(fp), dict):
            data["fingerprints"][fp] = {}
        data["fingerprints"][fp].update(self._timings)
        tmp = None
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            self._disk_state = ((os.path.getmtime(path), os.path.getsize(path)),
                                data)
        except OSError as e:
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
            warnings.warn(f"autotune cache not persisted to {path!r}: {e}")

    # --------------------------- measurement -------------------------- #
    def _random_inputs(self, specs: Sequence[TensorSpec],
                       dev: torch.device) -> List[torch.Tensor]:
        """``repro``'s inputs: standard normal floats, integers in {0, 1},
        from ``np.random.default_rng(0)``."""
        rng = np.random.default_rng(0)
        out = []
        for s in specs:
            if np.issubdtype(np.dtype(s.dtype), np.floating):
                arr = rng.standard_normal(s.shape, dtype=np.float32).astype(s.dtype)
            else:
                arr = rng.integers(0, 2, s.shape).astype(s.dtype)
            out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(dev))
        return out

    def measure(self, op: str, in_specs: Sequence[TensorSpec],
                attrs: Dict[str, Any]) -> Dict[str, float]:
        """Timings (seconds) for every candidate backend of (op, shapes,
        attrs).

        Incremental against the (possibly preloaded) cache: only backends
        with no cached timing are benchmarked, so a cache written under a
        different ``candidates`` restriction is topped up rather than
        trusted blindly.  The returned dict is filtered to the current
        candidate set and leaves out backends that could not run."""
        key = _sig_key(op, in_specs, attrs)
        avail = backends_for(op, in_specs, attrs)
        if self.candidates is not None:
            avail = [b for b in avail if b in self.candidates]
        times = dict(self._timings.get(key, {}))
        missing = [b for b in avail if b not in times]
        if missing:
            dev = resolve_device(self.device)
            sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
            inputs = self._random_inputs(in_specs, dev)
            with torch.no_grad():
                for b in missing:
                    fn = get_impl(op, b)
                    try:
                        fn(inputs, attrs)
                        sync()
                    except NotImplementedError:
                        # backend cannot run here (core/registry.py); remember
                        # that.  Anything else, a kernel that fails to build
                        # or launch among it, propagates.
                        times[b] = float("inf")
                        continue
                    best = float("inf")
                    for _ in range(self.reps):
                        sync()
                        t0 = time.perf_counter()
                        fn(inputs, attrs)
                        sync()
                        best = min(best, time.perf_counter() - t0)
                    times[b] = best
            self._timings[key] = times
            self.n_measured += 1
            if self.cache_path:
                self._save_cache()
        return {b: t for b, t in times.items()
                if b in avail and t != float("inf")}

    def choose(self, node: Node, in_specs: Sequence[TensorSpec]) -> str:
        key = _sig_key(node.op, in_specs, node.attrs)
        if key in self._cache:
            return self._cache[key]
        avail = backends_for(node.op, in_specs, node.attrs)
        if self.candidates is not None:
            avail = [b for b in avail if b in self.candidates]
        if len(avail) == 1:
            # nothing to compare: a sole candidate is not measured
            self._cache[key] = avail[0]
            return avail[0]
        times = self.measure(node.op, in_specs, node.attrs)
        if not times:
            raise ValueError(f"no runnable backend for {node.op}")
        best = min(times, key=times.get)  # type: ignore[arg-type]
        self._cache[key] = best
        return best

    def timings(self, node: Node, in_specs: Sequence[TensorSpec]) -> Dict[str, float]:
        """Every timing recorded for a node's signature (``inf`` for a
        backend that could not run), as measured or loaded."""
        return dict(self._timings.get(_sig_key(node.op, in_specs, node.attrs), {}))
