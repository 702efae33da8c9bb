"""Replica pool manager: spawn, warm-up gating, health, draining restarts
(counterpart of distribuuuu_tpu/serve/fleet/pool.py).

The pool owns replica *lifecycle*; the router (fleet/router.py) only
routes. Each replica is the existing single-engine
``python -m distribuuuu_tpu_torch.serve_net`` process on its own ephemeral
port (shared-nothing: its own CUDA context, engine, bucket graphs and
admission queue). On one card every replica is a process with its own
context on ``cuda:0``; the router sees no difference.

Lifecycle invariants:

* **Warm-up gates routability.** A spawned replica is registered with the
  router in the NOT-routable state; the pool polls its stats control
  frame (serve/protocol.py) until the replica reports every configured
  bucket shape warmed (``n_compiles == len(buckets)``: each bucket's graph
  captured), and only then marks it routable. The warm-up probe also
  records the replica's post-warm-up ``jit.compiles`` (graph captures)
  baseline, so "zero steady-state captures fleet-wide" is assertable from
  any later probe.
* **The target size is kept met.** ``target_size`` is the pool's one
  scaling input (the autoscaler moves it; ``--fleet N`` seeds it). The
  supervision loop replaces dead replicas and spawns toward the target;
  scale-down drains the victim first.
* **Draining restarts drain BEFORE exiting.** ``drain_stop`` marks the
  replica draining at the router (no new requests), THEN delivers
  SIGTERM, which chains through the replica's ``admission.install_drain``
  handler (the SIGTERM drain protocol): the replica stops accepting,
  completes every in-flight request, and exits. Only after exit is it
  removed from the router. ``restart_replica`` is that plus a
  replacement spawn — a zero-failed-request deploy.

Everything process-shaped is injectable (``spawn``/``probe``) so the fast
test tier exercises warm-up gating, drain ordering, and replacement logic
with fakes — no real processes, no torch.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

from distribuuuu_tpu_torch.serve import protocol
from distribuuuu_tpu_torch.serve.fleet.router import Router
from distribuuuu_tpu_torch.utils.logger import get_logger


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind-and-release)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def probe_stats(addr: tuple[str, int], timeout: float = 2.0) -> dict:
    """One stats control-frame roundtrip to a replica (raises OSError /
    ValueError when the replica is down or not yet listening)."""
    with socket.create_connection(addr, timeout=timeout) as conn:
        conn.settimeout(timeout)
        protocol.send_frame(conn, protocol.ctrl_request("stats"))
        payload = protocol.recv_frame(conn)
        if payload is None:
            raise ConnectionResetError(f"replica at {addr} closed during probe")
        return json.loads(payload)


def warmed_up(stats: dict) -> bool:
    """A replica is warm when every configured bucket shape is warmed —
    the gate between 'process is up' and 'safe to route to'."""
    buckets = stats.get("buckets") or []
    return bool(buckets) and int(stats.get("n_compiles", 0)) >= len(buckets)


class _ReplicaProc:
    """A spawned serve_net replica process (the default ``spawn``)."""

    def __init__(self, proc: subprocess.Popen, log_path: str):
        self._proc = proc
        self.log_path = log_path
        self.pid = proc.pid

    def poll(self):
        return self._proc.poll()

    def terminate(self) -> None:  # SIGTERM -> the replica's drain chain
        self._proc.terminate()

    def kill(self) -> None:
        self._proc.kill()

    def wait(self, timeout: float | None = None):
        return self._proc.wait(timeout=timeout)


def spawn_serve_net(cfg_path: str, *, host: str, out_dir: str):
    """Build the default ``spawn(replica_id, port)``: launch
    ``python -m distribuuuu_tpu_torch.serve_net --cfg <dumped cfg>
    SERVE.PORT <port>`` (the package's checkout first on ``PYTHONPATH``)
    with the replica's telemetry rank in ``DTPU_REPLICA_RANK`` and its
    stdout in ``{out_dir}/replica{id}.log``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))

    def spawn(replica_id: int, port: int) -> _ReplicaProc:
        os.makedirs(out_dir, exist_ok=True)
        log_path = os.path.join(out_dir, f"replica{replica_id}.log")
        env = dict(os.environ)
        # telemetry rank: 0 is the router; replicas are 1.. (replacement
        # replicas get fresh ids, hence fresh per-rank sink files)
        env["DTPU_REPLICA_RANK"] = str(replica_id + 1)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p)
        log = open(log_path, "a", buffering=1)
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "distribuuuu_tpu_torch.serve_net",
                "--cfg", cfg_path, "SERVE.PORT", str(port), "SERVE.HOST", host,
            ],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
        )
        log.close()  # the child holds the fd
        return _ReplicaProc(proc, log_path)

    return spawn


class PoolManager:
    """Replica lifecycle around a Router. ``spawn(replica_id, port)``
    returns a process handle (``poll``/``terminate``/``kill``/``wait``);
    ``probe(addr)`` returns a replica stats dict or raises. Both are
    injectable for the no-process test tier."""

    def __init__(
        self,
        router: Router,
        spawn,
        *,
        probe=probe_stats,
        host: str = "127.0.0.1",
        min_replicas: int = 1,
        max_replicas: int = 4,
        warmup_timeout_s: float = 180.0,
        warmup_poll_s: float = 0.25,
        health_period_s: float = 1.0,
        health_fails: int = 3,
        probe_timeout_s: float = 5.0,
        model: str = "",
    ):
        self.router = router
        self._spawn = spawn
        # model id this pool's replicas serve ("" = single-model fleet);
        # tags every add_replica so the router can model-filter _pick
        self.model = str(model)
        if probe is probe_stats:
            # the default probe gets the pool's timeout (a loaded 1-core
            # replica can sit on the GIL past a short probe window —
            # that is "busy", not "dead")
            probe = lambda addr: probe_stats(addr, timeout=probe_timeout_s)  # noqa: E731
        self._probe = probe
        self.host = host
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.warmup_timeout_s = float(warmup_timeout_s)
        self.warmup_poll_s = float(warmup_poll_s)
        self.health_period_s = float(health_period_s)
        self.health_fails = int(health_fails)
        self.target_size = 0
        self._lock = threading.Lock()
        self._scale_lock = threading.Lock()  # one spawn-decision at a time
        self._stop = threading.Event()
        self._supervisor: threading.Thread | None = None
        self._draining: dict[int, object] = {}  # rid -> handle (exiting)
        self.logger = get_logger()

    # -- spawn + warm-up ---------------------------------------------------
    def add_replica(self, *, wait: bool = True):
        """Spawn one replica and (optionally) block until it is warm and
        routable. Returns the router's Replica record."""
        port = free_port(self.host)
        rep = self.router.add_replica(self.host, port, model=self.model)
        handle = self._spawn(rep.id, port)
        rep.proc = handle
        self.logger.info(
            "fleet: replica %d spawning on %s:%d (pid %s)",
            rep.id, self.host, port, getattr(handle, "pid", "?"),
        )
        if wait:
            self._wait_warm(rep)
        else:
            threading.Thread(
                target=self._wait_warm, args=(rep,), daemon=True
            ).start()
        return rep

    def _wait_warm(self, rep) -> bool:
        """Poll the replica's stats endpoint until every bucket shape is
        warmed, then mark it routable. A replica that dies or exceeds
        the warm-up budget is removed (and the supervisor loop respawns
        toward the target)."""
        deadline = time.perf_counter() + self.warmup_timeout_s
        while time.perf_counter() < deadline and not self._stop.is_set():
            if rep.proc is not None and rep.proc.poll() is not None:
                break  # died during warm-up
            try:
                stats = self._probe(rep.addr)
            except (OSError, ValueError):
                time.sleep(self.warmup_poll_s)
                continue
            if warmed_up(stats):
                rep.stats = stats
                rep.warmed = True
                # the zero-steady-state-recompile baseline: any later
                # probe reporting jit.compiles above this is a recompile
                rep.warm_jit_compiles = int(stats.get("jit_compiles", 0))
                self.router.mark_routable(rep.id)
                self.logger.info(
                    "fleet: replica %d routable (%d bucket shapes warmed, "
                    "jit.compiles baseline %d)",
                    rep.id, int(stats.get("n_compiles", 0)),
                    int(stats.get("jit_compiles", 0)),
                )
                return True
            time.sleep(self.warmup_poll_s)
        self.logger.warning(
            "fleet: replica %d failed warm-up — removing", rep.id
        )
        self._destroy(rep, reason="warmup_failed")
        return False

    # -- scaling -----------------------------------------------------------
    def set_target(self, n: int) -> int:
        """Set the target size without acting on it now (the supervision
        loop spawns toward it); returns the clamped value."""
        n = max(self.min_replicas, min(self.max_replicas, int(n)))
        with self._lock:
            self.target_size = n
        return n

    def scale_to(self, n: int, *, wait: bool = True) -> int:
        """Move the target size to ``n`` (clamped to the configured
        min/max budget) and act on the delta now: spawn up, or drain the
        newest replicas down. Returns the clamped target."""
        n = self.set_target(n)
        current = self._members()
        if n > len(current):
            self._spawn_toward_target()
            if wait:
                self._wait_routable(n)
        elif n < len(current):
            # drain the newest first (oldest replicas keep their warm caches)
            for rep in sorted(current, key=lambda r: -r.id)[: len(current) - n]:
                self.drain_stop(rep.id, wait=wait)
        return n

    def _spawn_toward_target(self) -> list:
        """Spawn however many replicas the target is missing. Registration
        happens under the scale lock, so a concurrent supervision pass and
        an explicit scale/restart cannot double-spawn; warm-up proceeds in
        background threads either way."""
        with self._scale_lock:
            missing = self.target_size - len(self._members())
            return [self.add_replica(wait=False) for _ in range(missing)]

    def _wait_routable(self, n: int) -> bool:
        deadline = time.perf_counter() + self.warmup_timeout_s
        while time.perf_counter() < deadline and not self._stop.is_set():
            if self._n_routable() >= n:
                return True
            time.sleep(0.1)
        return self._n_routable() >= n

    def _n_routable(self) -> int:
        return sum(1 for r in self._own() if r.routable)

    def _own(self) -> list:
        """THIS pool's replicas. The router is shared across pools in a
        multi-model fleet, so every lifecycle decision —
        target counting, warm-up waits, health, shutdown — must filter
        by the pool's model tag or pools start managing (and refusing to
        spawn against) each other's replicas."""
        return [r for r in self.router.replicas() if r.model == self.model]

    def _members(self) -> list:
        """Replicas that count toward the target: routable or warming —
        not the ones already draining out."""
        return [
            r for r in self._own()
            if not r.draining and r.id not in self._draining
        ]

    # -- draining restarts -------------------------------------------------
    def drain_stop(self, rid: int, *, wait: bool = True,
                   timeout: float = 60.0) -> bool:
        """Stop one replica with zero failed requests, in this order:
        1) router stops routing to it (mark_draining), 2) SIGTERM chains
        through its drain handler (in-flight requests complete), 3) wait
        for exit, 4) remove from the router."""
        rep = self.router.get_replica(rid)
        if rep is None:
            return False
        self.router.mark_draining(rid)
        with self._lock:
            self._draining[rid] = rep.proc
        if rep.proc is not None:
            try:
                rep.proc.terminate()
            except (OSError, ProcessLookupError):
                pass

        def reap():
            deadline = time.perf_counter() + timeout
            while time.perf_counter() < deadline:
                if rep.proc is None or rep.proc.poll() is not None:
                    break
                time.sleep(0.05)
            else:
                if rep.proc is not None:  # drain hung past the grace window
                    try:
                        rep.proc.kill()
                    except (OSError, ProcessLookupError):
                        pass
            self.router.remove_replica(rid)
            with self._lock:
                self._draining.pop(rid, None)
            self.logger.info("fleet: replica %d drained and exited", rid)

        if wait:
            reap()
        else:
            threading.Thread(target=reap, daemon=True).start()
        return True

    def restart_replica(self, rid: int, *, wait: bool = True) -> bool:
        """Draining restart: drain-stop ``rid``, then spawn toward the
        target (warm-up gated as always; the scale lock keeps a racing
        supervision pass from double-replacing). Zero failed requests by
        construction — the router never routes to a draining replica."""
        self._emit_scale("restart", f"draining restart of replica {rid}")
        if not self.drain_stop(rid, wait=wait):
            return False
        self._spawn_toward_target()
        if wait:
            return self._wait_routable(self.target_size)
        return True

    # -- supervision (health + target maintenance) -------------------------
    def start_supervisor(self) -> None:
        if self._supervisor is not None:
            return
        self._supervisor = threading.Thread(
            target=self._supervise, name="fleet-pool-supervisor", daemon=True
        )
        self._supervisor.start()

    def _supervise(self) -> None:
        while not self._stop.wait(self.health_period_s):
            try:
                self.health_check()
                self._maintain_target()
            except Exception:  # noqa: BLE001 — supervision must not die
                self.logger.exception("fleet: supervisor iteration failed")

    def health_check(self) -> None:
        """One probe pass: refresh every routable replica's load snapshot
        (queue depth, occupancy, jit.compiles) for the router's
        least-loaded policy; HEALTH_FAILS consecutive probe failures or a
        dead process marks the replica dead and removes it. Replicas
        still WARMING are ``_wait_warm``'s to judge (it has the generous
        warm-up budget) — probing them here would kill every fresh
        replica before its first bucket is captured."""
        for rep in self._own():
            if rep.draining or rep.id in self._draining or not rep.warmed:
                continue
            if rep.proc is not None and rep.proc.poll() is not None:
                self._destroy(rep, reason="process_exited")
                continue
            try:
                stats = self._probe(rep.addr)
            except (OSError, ValueError):
                rep.fails += 1
                if rep.fails >= self.health_fails:
                    self._destroy(rep, reason="health_probe_failed")
                continue
            rep.fails = 0
            rep.stats = stats
            if not rep.routable and warmed_up(stats):
                # a transient transport failure knocked it out of routing;
                # the probe just proved it healthy again
                self.router.mark_routable(rep.id)

    def _maintain_target(self) -> None:
        for rep in self._spawn_toward_target():
            self.logger.info(
                "fleet: below target (%d), spawned replacement replica %d",
                self.target_size, rep.id,
            )
            self._emit_scale("replace", "replacing dead replica")

    def _destroy(self, rep, *, reason: str) -> None:
        self.logger.warning("fleet: replica %d dead (%s)", rep.id, reason)
        self.router.remove_replica(rep.id)
        if rep.proc is not None:
            try:
                rep.proc.kill()
            except (OSError, ProcessLookupError):
                pass

    def _emit_scale(self, action: str, reason: str) -> None:
        from distribuuuu_tpu_torch.telemetry import spans

        n = len(self._members())
        spans.emit_event(
            "fleet.scale", action=action, reason=reason,
            n_before=n, n_after=self.target_size,
        )

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, timeout: float = 60.0) -> None:
        """Drain every replica of THIS pool (SIGTERM chain) and stop
        supervision; other pools' replicas on the shared router are
        theirs to drain."""
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=self.health_period_s + 5)
        for rep in self._own():
            self.drain_stop(rep.id, wait=False, timeout=timeout)
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline and self._own():
            time.sleep(0.05)
        for rep in self._own():  # anything that refused to die
            if rep.proc is not None:
                try:
                    rep.proc.kill()
                except (OSError, ProcessLookupError):
                    pass
            self.router.remove_replica(rep.id)


class FleetService:
    """The composed fleet: Router + PoolManager + (optional) Autoscaler,
    configured from the ``SERVE.FLEET`` node: what ``serve_net --fleet N``
    runs."""

    def __init__(self, cfg, n_replicas: int, *, cfg_path: str,
                 out_dir: str | None = None, autoscale: bool | None = None):
        fl = cfg.SERVE.FLEET
        self.cfg = cfg
        self.n_initial = int(n_replicas)
        self.router = Router(
            request_timeout_s=fl.REQUEST_TIMEOUT_S,
            long_prompt_threshold=cfg.SERVE.LONG_PROMPT_THRESHOLD,
            short_p99_slo_ms=cfg.SERVE.SHORT_P99_SLO_MS,
            long_p99_slo_ms=cfg.SERVE.LONG_P99_SLO_MS,
        )
        fleet_dir = os.path.join(out_dir or cfg.OUT_DIR, "fleet")
        self.pool = PoolManager(
            self.router,
            spawn_serve_net(cfg_path, host=cfg.SERVE.HOST, out_dir=fleet_dir),
            host=cfg.SERVE.HOST,
            min_replicas=fl.MIN_REPLICAS,
            max_replicas=fl.MAX_REPLICAS,
            warmup_timeout_s=fl.WARMUP_TIMEOUT_S,
            health_period_s=fl.HEALTH_PERIOD_S,
            health_fails=fl.HEALTH_FAILS,
        )
        self.autoscaler = None
        if fl.AUTOSCALE if autoscale is None else autoscale:
            from distribuuuu_tpu_torch.serve.fleet.autoscale import (
                Autoscaler,
                AutoscalePolicy,
            )

            self.autoscaler = Autoscaler(
                self.router, self.pool,
                AutoscalePolicy(
                    p99_target_ms=fl.P99_TARGET_MS,
                    queue_high=fl.QUEUE_HIGH,
                    queue_low=fl.QUEUE_LOW,
                    scale_down_frac=fl.SCALE_DOWN_FRAC,
                    breach_n=fl.BREACH_N,
                    cooldown_s=fl.COOLDOWN_S,
                    min_replicas=fl.MIN_REPLICAS,
                    max_replicas=fl.MAX_REPLICAS,
                ),
                eval_period_s=fl.EVAL_PERIOD_S,
            )
        self.emit_interval_s = fl.EMIT_INTERVAL_S
        self._frozen = False

    def start(self, *, wait: bool = True) -> "FleetService":
        """Spawn the initial replicas concurrently (each warm-up gated);
        with ``wait`` block until all are routable (or the warm-up budget
        lapses), then start supervision and the autoscaler loop."""
        from distribuuuu_tpu_torch.serve.fleet.router import freeze_heap

        n = self.pool.set_target(self.n_initial)
        self.pool._spawn_toward_target()
        if wait:
            self.pool._wait_routable(n)
        self.pool.start_supervisor()
        if self.autoscaler is not None:
            self.autoscaler.start()
        if not self._frozen:  # the router serves from a frozen heap
            freeze_heap()
            self._frozen = True
        return self

    def serve(self, listener, should_stop, poll_s: float = 0.25) -> None:
        self.router.serve(
            listener, should_stop, poll_s=poll_s,
            emit_interval_s=self.emit_interval_s,
        )

    def shutdown(self) -> None:
        from distribuuuu_tpu_torch.serve.fleet.router import thaw_heap

        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.pool.shutdown()
        self.router.emit_telemetry()
        if self._frozen:
            self._frozen = False
            thaw_heap()
