"""Deterministic fault injection: named sites, armed by tests or environment.

Host-only copy of ``albedo_tpu/utils/faults.py`` for the PyTorch port
(plain ``threading`` locks; the ``kill`` exit code defined here). Chaos
engineering for the offline pipeline and the serving plane. Production
code declares **fault sites** — named points where reality can go wrong —
and calls ``site.hit()`` (optionally with the file path being touched).
Unarmed, a hit is one dict lookup under a lock: cheap enough to leave in the
hot-ish paths permanently. Armed, the Nth hit performs the configured fault:

==========  ================================================================
kind        effect at the Nth hit
==========  ================================================================
``error``   raise :class:`FaultInjected` (RuntimeError)
``ioerror`` raise ``OSError`` (what a dying disk/NFS mount raises)
``corrupt`` flip one byte of the file at ``path`` (bit-level corruption;
            directories corrupt their first regular file)
``delay``   sleep ``param`` seconds (default 0.05), then continue
``kill``    ``os._exit(137)`` — a hard SIGKILL-style preemption, no cleanup
``term``    ``os.kill(os.getpid(), SIGTERM)`` — a polite preemption notice,
            exercising the SIGTERM checkpoint-and-exit path
``oom``     raise :class:`InjectedResourceExhausted` — a stand-in for the
            ``XlaRuntimeError: RESOURCE_EXHAUSTED`` a real over-HBM
            allocation throws (``utils.retry.is_resource_exhausted``
            classifies both as permanent; ``utils.capacity.admit`` converts
            one fired at ``capacity.admit`` into an over-budget verdict)
``loss``    raise :class:`InjectedDeviceLoss` — a stand-in for the
            ``DEADLINE_EXCEEDED`` / distributed-runtime heartbeat failure a
            dead or hung mesh shard surfaces as mid-collective
            (``utils.retry.is_collective_lost`` classifies both as
            permanent; the elastic sharded fit (``parallel/elastic.py``)
            catches one fired at ``als.shard.collective`` and runs the real
            checkpoint -> remesh -> resume machinery)
==========  ================================================================

Arming is programmatic (``faults.site("artifact.load").arm(kind="corrupt")``)
or environment-driven for subprocess chaos tests::

    ALBEDO_FAULTS="artifact.load:corrupt@1,checkpoint.save:kill@2"

``site:kind@N`` fires at the Nth hit (1-based, default 1); ``site:kind@N*M``
fires for M consecutive hits (``*0`` = every hit from N on). Every firing is
counted in the process-global ``albedo_faults_fired_total{site=...}``
(``utils.events``) so chaos runs can assert — from `/metrics` — that the
fault actually happened.

Sites of the ported layers: ``serving.admit`` (every admission decision of
the overload controller), ``retrieval.build`` and ``retrieval.query`` (the
retrieval bank's build step and every query batch).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from pathlib import Path

from albedo_tpu_torch.utils import events

_ENV_VAR = "ALBEDO_FAULTS"
EXIT_KILLED = 137  # what a SIGKILL-preempted process reports
KINDS = ("error", "ioerror", "corrupt", "delay", "kill", "term", "oom", "loss")


class FaultInjected(RuntimeError):
    """The generic injected failure (kind=error)."""


class InjectedResourceExhausted(MemoryError):
    """The injected OOM (kind=oom): message and classification match what a
    real ``XlaRuntimeError: RESOURCE_EXHAUSTED`` looks like to the retry
    predicates, without this module importing jax."""


class InjectedDeviceLoss(RuntimeError):
    """The injected mid-collective device loss (kind=loss): message and
    classification match what a dead/hung mesh shard surfaces as on a real
    slice — jaxlib's ``DEADLINE_EXCEEDED`` collective timeout or a
    distributed-runtime heartbeat failure — so
    ``utils.retry.is_collective_lost`` treats both identically, without
    this module importing jax."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: fire at the ``at``-th hit AFTER arming (1-based),
    for ``times`` hits (0 = every hit from ``at`` on). ``base`` is the
    site's hit count at arm time (set by the registry)."""

    site: str
    kind: str = "error"
    at: int = 1
    times: int = 1
    param: float = 0.05  # delay seconds (kind=delay)
    base: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")
        if self.at < 1:
            raise ValueError(f"fault 'at' is 1-based, got {self.at}")

    def active_for(self, hit_number: int) -> bool:
        n = hit_number - self.base
        if n < self.at:
            return False
        return self.times == 0 or n < self.at + self.times


def _flip_byte(path: Path, offset_seed: int = 0) -> None:
    """Deterministically flip one byte of ``path`` (dirs: first regular file,
    sorted). Empty files grow one garbage byte so the change is observable."""
    path = Path(path)
    if path.is_dir():
        files = sorted(p for p in path.rglob("*") if p.is_file())
        if not files:
            return
        path = files[0]
    data = bytearray(path.read_bytes())
    if not data:
        path.write_bytes(b"\xff")
        return
    i = (len(data) // 2 + offset_seed) % len(data)
    data[i] ^= 0xFF
    path.write_bytes(bytes(data))


class FaultRegistry:
    """Hit counters + armed specs for every named site (thread-safe)."""

    def __init__(self, env: str | None = None):
        self._lock = threading.Lock()
        self._specs: dict[str, list[FaultSpec]] = {}
        self._hits: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self.load_env(env if env is not None else os.environ.get(_ENV_VAR, ""))

    # --- arming -------------------------------------------------------------

    def arm(self, site: str, kind: str = "error", at: int = 1, times: int = 1,
            param: float = 0.05) -> FaultSpec:
        with self._lock:
            spec = FaultSpec(
                site=site, kind=kind, at=at, times=times, param=param,
                base=self._hits.get(site, 0),  # 'at' counts from arming
            )
            self._specs.setdefault(site, []).append(spec)
        return spec

    def disarm(self, site: str | None = None) -> None:
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)

    def reset(self) -> None:
        """Disarm everything and zero hit/fired counters (test isolation)."""
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            self._fired.clear()

    def load_env(self, value: str) -> None:
        """Parse ``site:kind@N[*M]`` comma-separated specs (see module doc)."""
        for chunk in (value or "").split(","):
            chunk = chunk.strip()
            if not chunk:
                continue
            try:
                site, _, rest = chunk.partition(":")
                kind, _, when = rest.partition("@")
                at, times = 1, 1
                if when:
                    n, _, m = when.partition("*")
                    at = int(n)
                    if m != "":
                        times = int(m)
                self.arm(site, kind=kind or "error", at=at, times=times)
            except ValueError as e:
                # This parse runs at import in EVERY albedo process; a typo'd
                # spec leaking into an unrelated job must name its source.
                raise ValueError(
                    f"invalid {_ENV_VAR} spec {chunk!r} "
                    f"(expected site:kind@N[*M]): {e}"
                ) from e

    # --- observation --------------------------------------------------------

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def fired(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)

    def armed(self, site: str) -> list[FaultSpec]:
        with self._lock:
            return list(self._specs.get(site, ()))

    # --- the injection point ------------------------------------------------

    def hit(self, site: str, path: str | os.PathLike | None = None) -> None:
        """Record a hit at ``site``; perform any armed fault that matches.

        ``path`` is the file/directory the caller is about to touch — required
        for ``corrupt`` faults to have something to flip (a corrupt fault at a
        path-less hit is a no-op rather than an error, so one env spec can arm
        heterogeneous sites).
        """
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            spec = next(
                (s for s in self._specs.get(site, ()) if s.active_for(n)), None
            )
            if spec is None:
                return
            self._fired[site] = self._fired.get(site, 0) + 1
        events.faults_fired.inc(site=site)
        self._perform(spec, site, path)

    def _perform(self, spec: FaultSpec, site: str, path) -> None:
        if spec.kind == "delay":
            time.sleep(spec.param)
            return
        if spec.kind == "corrupt":
            if path is not None:
                _flip_byte(Path(path))
            return
        if spec.kind == "kill":
            os._exit(EXIT_KILLED)
        if spec.kind == "term":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if spec.kind == "ioerror":
            raise OSError(f"injected IOError at fault site {site!r}")
        if spec.kind == "oom":
            raise InjectedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected out-of-memory at fault site "
                f"{site!r} (simulated over-HBM allocation)"
            )
        if spec.kind == "loss":
            raise InjectedDeviceLoss(
                f"DEADLINE_EXCEEDED: injected device loss at fault site "
                f"{site!r} (simulated collective timeout / heartbeat failure "
                f"of a mesh shard)"
            )
        raise FaultInjected(f"injected fault at site {site!r}")


@dataclasses.dataclass(frozen=True)
class FaultSite:
    """A named injection point, bound to the global registry.

    Modules create one at import (``_LOAD_FAULT = faults.site("artifact.load")``)
    and call ``.hit()`` where the fault belongs; tests arm through the same
    handle.
    """

    name: str

    def hit(self, path: str | os.PathLike | None = None) -> None:
        FAULTS.hit(self.name, path=path)

    def arm(self, kind: str = "error", at: int = 1, times: int = 1,
            param: float = 0.05) -> FaultSpec:
        return FAULTS.arm(self.name, kind=kind, at=at, times=times, param=param)

    def disarm(self) -> None:
        FAULTS.disarm(self.name)

    def hits(self) -> int:
        return FAULTS.hits(self.name)

    def fired(self) -> int:
        return FAULTS.fired(self.name)


# The process-wide registry: arms from $ALBEDO_FAULTS at import, so chaos
# subprocesses are configured before any albedo code runs.
FAULTS = FaultRegistry()


def site(name: str) -> FaultSite:
    return FaultSite(name)


def hit(name: str, path: str | os.PathLike | None = None) -> None:
    FAULTS.hit(name, path=path)


def arm(name: str, kind: str = "error", at: int = 1, times: int = 1,
        param: float = 0.05) -> FaultSpec:
    return FAULTS.arm(name, kind=kind, at=at, times=times, param=param)


def disarm(name: str | None = None) -> None:
    FAULTS.disarm(name)


def reset() -> None:
    FAULTS.reset()
