"""RTT_XLA_WATCHDOG — runtime oracle for step-region hygiene (port of
``ray_tpu/_private/xla_watchdog.py``, under the reference's names).

``RTT_XLA_WATCHDOG=1`` arms two checks, both scoped to *step regions*:
the ``compile_budget("<site>")`` context managers wrapped around the
steady-state dispatches (the train step, the LLM prefill and decode
forwards).  Every site is a row of ``lock_watchdog.COMPILE_BUDGETS``.

- **No host reads inside a step region.**  While armed, the port
  interposes on the tensor's host reads: ``Tensor.item``, ``tolist``,
  ``cpu``, ``numpy``, ``__array__`` (hence ``np.asarray``),
  ``__float__`` / ``__int__`` / ``__bool__``, and ``Tensor.to`` a CPU
  device from another device.  A host read on a thread inside a step
  region raises :class:`XlaHygieneViolation` with the tensor's shape,
  dtype and the reading stack; ``cpu()`` and the rest raise for a CPU
  tensor too (on the card each is a synchronisation; on the CPU, as on
  the reference's CPU rig, no transfer exists for a native guard to
  see), while ``to`` a CPU tensor's own device is no read.  The
  interposers are process-wide patches that look at the calling
  thread's region stack only.  On the card the native guard,
  ``torch.cuda.set_sync_debug_mode`` (the counterpart of JAX's transfer
  guard), also catches syncs that no interposer sees (a blocking copy,
  ``nonzero``).  That mode is process-wide, so the first region to
  enter raises it from off to "warn" and the last to leave, on any
  thread, restores it; the warning fires on the thread that synced,
  where a hook turns it into the violation inside a region and drops it
  outside one, so a designed sync of another thread (the engine loop's
  logits pull beside ``prefill_remote``) passes.  A mode the caller set
  itself ("error", as ``chip_smoke.py``'s timed steps do) is left as it
  is, and its error inside a region becomes the violation.  Designed
  syncs (the engine's logits pulls, the caller's reads of the metrics)
  sit OUTSIDE the regions and stay legal.

- **Zero steady-state recompiles.**  Eager PyTorch compiles nothing; the
  counterpart of a new XLA program is a new input signature at a site,
  the shapes and dtypes that reach it (``compile_budget.see``).  A new
  one is charged to the innermost active region on the thread.  A
  region owner past ``budget + RTT_XLA_WATCHDOG_WARMUP`` raises on
  region exit; while the overrun is in flight the profiler shows the
  thread under ``waiting:recompile:<site>``, and the flight recorder
  keeps a record.

Zero-cost when disarmed: ``compile_budget`` does nothing on entry,
nothing is interposed, and ``see`` is one set lookup.
"""

from __future__ import annotations

import os
import threading
import traceback
import warnings
from typing import Dict, Hashable, Iterable, List, Tuple

from ray_tpu_torch._private.lock_watchdog import COMPILE_BUDGETS

# the message of c10's warn_or_error_on_sync, in either mode
_SYNC_MSG = "called a synchronizing CUDA operation"
_HOST_READS = ("item", "tolist", "cpu", "numpy", "__array__", "__float__",
               "__int__", "__bool__")


class XlaHygieneViolation(RuntimeError):
    """A step region saw a host read or an over-budget recompile."""


def xla_watchdog_enabled() -> bool:
    return os.environ.get("RTT_XLA_WATCHDOG") == "1"


def _warmup_budget() -> int:
    try:
        return int(os.environ.get("RTT_XLA_WATCHDOG_WARMUP", "0"))
    except ValueError:
        return 0


def signature(leaves: Iterable) -> tuple:
    """An input signature: each leaf's shape and dtype."""
    return tuple((tuple(getattr(x, "shape", ())),
                  getattr(x, "dtype", type(x))) for x in leaves)


# --------------------------------------------------------------- state
# Innermost-first stack of active compile_budget regions on this thread
# (the signature charge and the host-read interposers charge the top).
_TLS = threading.local()

# site -> [compiles, host-read violations]; guarded by: _XLA_STATS_LOCK
_XLA_STATS: Dict[str, List[int]] = {}
_XLA_STATS_LOCK = threading.Lock()

_INSTALL_LOCK = threading.Lock()
_installed = False
_native = False          # the card's sync-debug guard is available

# The native guard's process-wide state: armed regions on every thread
# and the mode found when the first entered.
_NATIVE_LOCK = threading.Lock()
_native_depth = 0        # guarded by: _NATIVE_LOCK
_native_prev = 0         # guarded by: _NATIVE_LOCK


def xla_stats() -> Dict[str, Tuple[int, int]]:
    """{site: (compiles, host_read_violations)} since the last reset."""
    with _XLA_STATS_LOCK:
        return {k: (v[0], v[1]) for k, v in _XLA_STATS.items()}


def reset_xla_stats() -> None:
    with _XLA_STATS_LOCK:
        _XLA_STATS.clear()


def _region_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _note_compile() -> None:
    st = _region_stack()
    if not st:
        return
    region = st[-1]
    region._compiles += 1
    with _XLA_STATS_LOCK:
        _XLA_STATS.setdefault(region.site, [0, 0])[0] += 1
    if region._compiles > region._allowed():
        region._overrun = True
        # visible while the violation is in flight: a profiler sample
        # between this charge and the region's exit sees the step under
        # waiting:recompile:<site>
        from ray_tpu_torch.util import profiler
        profiler.note_lock_wait(f"recompile:{region.site}")


def _host_read(what: str, t) -> None:
    """Called by the interposers on every host read while armed."""
    st = _region_stack()
    if not st:
        return
    region = st[-1]
    with _XLA_STATS_LOCK:
        _XLA_STATS.setdefault(region.site, [0, 0])[1] += 1
    shape = tuple(t.shape) if t is not None else None
    dtype = getattr(t, "dtype", None)
    stack = "".join(traceback.format_stack(limit=16)[:-2])
    from ray_tpu_torch._private import flight_recorder
    if flight_recorder.enabled():
        flight_recorder.record(
            "xlatransfer", f"{region.site} {what} shape={shape}")
    raise XlaHygieneViolation(
        f"host transfer inside step region {region.site!r}: {what} of "
        f"shape={shape} dtype={dtype} — step paths must stay on the "
        f"device (move the read outside the compile_budget region or "
        f"remove the sync).  Transfer point:\n{stack}")


def _install_interposers() -> None:
    """Wrap the tensor's host reads and, with a card, hook the native
    guard's warnings.  Installed once, process-wide, at the first armed
    region entry; each wrapper is a passthrough when no region is active
    on the calling thread."""
    global _installed, _native
    with _INSTALL_LOCK:
        if _installed:
            return
        import torch

        def wrap(name):
            orig = getattr(torch.Tensor, name)

            def guarded(self, *a, **kw):
                if _region_stack():
                    _host_read(f"Tensor.{name}", self)
                return orig(self, *a, **kw)

            guarded.__name__ = name
            return guarded

        for name in _HOST_READS:
            setattr(torch.Tensor, name, wrap(name))

        orig_to = torch.Tensor.to
        parse_to = torch._C._nn._parse_to

        def guarded_to(self, *a, **kw):
            if _region_stack() and self.device.type != "cpu":
                dev = parse_to(*a, **kw)[0]
                if dev is not None and dev.type == "cpu":
                    _host_read("Tensor.to(cpu)", self)
            return orig_to(self, *a, **kw)

        torch.Tensor.to = guarded_to

        _native = torch.cuda.is_available()
        if _native:
            warnings.filterwarnings("always", message=_SYNC_MSG)
            shown = warnings.showwarning

            def showwarning(message, category, filename, lineno, file=None,
                            line=None):
                if _SYNC_MSG in str(message):
                    if _region_stack():
                        _host_read("a synchronizing CUDA operation", None)
                    if _native_prev == 0:
                        return      # another thread's designed sync
                shown(message, category, filename, lineno, file, line)

            warnings.showwarning = showwarning
        _installed = True


def _native_enter() -> None:
    global _native_depth, _native_prev
    import torch
    with _NATIVE_LOCK:
        if _native_depth == 0:
            _native_prev = torch.cuda.get_sync_debug_mode()
            if _native_prev == 0:
                torch.cuda.set_sync_debug_mode("warn")
        _native_depth += 1


def _native_exit() -> None:
    global _native_depth
    import torch
    with _NATIVE_LOCK:
        _native_depth -= 1
        if _native_depth == 0 and _native_prev == 0:
            torch.cuda.set_sync_debug_mode(0)


class compile_budget:
    """One step region: scoped host-read guard + signature accounting.

    Long-lived: the owner (a ModelRunner, a train program) creates it
    once and re-enters it around every steady-state dispatch; the
    signatures it has seen span the owner's life, so "zero recompiles
    after warmup" is checked per owner, not per call:

        self._budget = compile_budget("llm.prefill", len(buckets))
        ...
        with self._budget:
            self._budget.see(("prefill", bucket))
            out = forward_prefill(params, toks, cfg)
        logits = out.cpu()                # designed read: OUTSIDE

    ``budget=`` overrides the ``COMPILE_BUDGETS`` default for sites whose
    ceiling is config-driven (the bucket-table length); the table row is
    still mandatory.  Entry and exit are per thread: two threads may be
    inside one owner's region at once.  No-op unless
    ``RTT_XLA_WATCHDOG=1``.
    """

    __slots__ = ("site", "budget", "_compiles", "_overrun", "_seen")

    def __init__(self, site: str, budget: int = None):
        self.site = site
        self.budget = budget
        self._compiles = 0
        self._overrun = False
        self._seen: set = set()

    def _allowed(self) -> int:
        base = self.budget if self.budget is not None \
            else COMPILE_BUDGETS.get(self.site, 0)
        return int(base) + _warmup_budget()

    def see(self, key: Hashable) -> bool:
        """Note an input signature at this owner; True when it is new.
        A new one is charged as a compile to the innermost armed region
        on this thread (none when disarmed)."""
        if key in self._seen:
            return False
        self._seen.add(key)
        _note_compile()
        return True

    def __enter__(self):
        if not xla_watchdog_enabled():
            return self
        if self.site not in COMPILE_BUDGETS:
            raise XlaHygieneViolation(
                f"compile_budget site {self.site!r} is not declared in "
                f"lock_watchdog.COMPILE_BUDGETS")
        _install_interposers()
        if _native:
            _native_enter()
        _region_stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        st = _region_stack()
        if not st or st[-1] is not self:
            return False             # not armed on this thread
        st.pop()
        if _native:
            _native_exit()
        if self._overrun:
            self._overrun = False
            from ray_tpu_torch.util import profiler
            profiler.clear_lock_wait()
            from ray_tpu_torch._private import flight_recorder
            if flight_recorder.enabled():
                flight_recorder.record(
                    "xlarecompile",
                    f"{self.site} saw {self._compiles} signatures over "
                    f"budget {self._allowed()}")
            if exc_type is None:
                raise XlaHygieneViolation(
                    f"steady-state recompile at site {self.site!r}: "
                    f"{self._compiles} distinct input signatures, over "
                    f"the declared budget {self._allowed()} "
                    f"(COMPILE_BUDGETS[{self.site!r}]"
                    f"{' + warmup' if _warmup_budget() else ''}) — a "
                    f"shape or dtype is changing per call, a retrace of "
                    f"the step: pad it to a declared bucket")
        # the native guard's own error (a mode of "error" the caller
        # set) converts to the typed violation with the site attached
        if exc is not None and not isinstance(exc, XlaHygieneViolation) \
                and _SYNC_MSG in str(exc):
            raise XlaHygieneViolation(
                f"host transfer inside step region {self.site!r}: "
                f"{exc}") from exc
        return False
