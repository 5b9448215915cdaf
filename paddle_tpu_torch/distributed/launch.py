"""Process launcher and elastic membership — port of
``paddle_tpu/distributed/launch.py``.

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
train.py`` starts the trainers with the reference launcher's environment,
variable for variable (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``PADDLE_NODE_RANK``, ``PADDLE_MASTER``,
``PADDLE_STORE_PORT``, ``PADDLE_RESTART_EPOCH``, and on a relaunch the
goodput stamp ``PADDLE_TPU_GOODPUT_DOWN_AT`` or ``_RESIZE_AT``), hosts
the job's TCPStore, and supervises:

* a trainer that crashes ends the attempt; the launcher relaunches all of
  them (``max_restarts`` crash budget) under a new restart epoch, which
  namespaces every rendezvous key, so no attempt reads a dead one's;
* trainers exiting ``RESUMABLE_EXIT_CODE`` (79, a preemption with its
  checkpoint committed) relaunch without spending the crash budget
  (``max_resumes``, default 8);
* trainers exiting ``RESIZE_EXIT_CODE`` (83) left at a consensus resize
  boundary: with survivors still running it is an in-place resize, with
  every rank gone a relaunch at the agreed world (``max_resizes``,
  default 8);
* ``np_range=(min, max)`` (``--np min:max``) scales in to the survivors
  and out again when ``__scale_out`` is bumped; several launchers
  (``--nnodes``, ``--node_rank``, ``--master host:port``) share one
  store and agree on membership per epoch (``_elastic_multinode``).

Each process is one rank on one device: under NCCL a trainer takes the
card ``PADDLE_LOCAL_RANK`` (``env.init_parallel_env``). The reference
reads its budgets from ``PADDLE_TPU_MAX_RESUMES`` and
``PADDLE_TPU_MAX_RESIZES``; here they are the arguments ``max_resumes``
and ``max_resizes`` (``--max_resumes``, ``--max_resizes``). When an
attempt fails, the survivors are killed (SIGKILL): a survivor may be
blocked in a gloo collective with its failed peer, and the preemption
listener turns SIGTERM into a flag that such a survivor never reads.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional

from paddle_tpu_torch.resilience.elastic import (RESIZE_EXIT_CODE,
                                                 elastic_prefix)
from paddle_tpu_torch.resilience.preemption import (RESUMABLE_EXIT_CODE,
                                                    preempt_stop_key)

from .tcp_store import TCPStore

__all__ = ["launch", "ElasticManager", "parse_np", "main"]

_RESUME_GRACE = 60.0   # wait this long for peers' coordinated final saves
_RESIZE_GRACE = 5.0    # window to tell an in-place resize (survivors keep
                       # running) from a coordinated resize-relaunch (all
                       # ranks exit 83 together)


_DEFAULT_BUDGET = 8  # the reference's default resume and resize budgets


def _resize_target_world(store, epoch) -> Optional[int]:
    """The consensus resize verdict's agreed world size, if one was
    published for this restart epoch (``__elastic/{epoch}/g{gen}/stop``
    holds ``stop_at:new_world:reason``; survivors bump ``gen`` after an
    in-place resize, so check the current and previous generation)."""
    try:
        raw = store.get(f"__elastic/{epoch}/gen")
        gen = int(raw) if raw else 0
        for g in (gen, gen - 1):
            if g < 0:
                continue
            v = store.get(f"{elastic_prefix(g, str(epoch))}/stop")
            if v:
                return int(v.decode(errors="replace").split(":")[1])
    except (OSError, RuntimeError, ValueError, IndexError):
        pass
    return None


def _kill(procs):
    """End an attempt's trainers still running and reap them all."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


class ElasticManager:
    """Store-backed membership (reference: elastic/manager.py:126 —
    register with TTL lease + heartbeat thread; watch for dead peers)."""

    def __init__(self, store: TCPStore, rank: int, world_size: int,
                 heartbeat_interval: float = 1.0,
                 heartbeat_timeout: float = 5.0):
        self._store = store
        self.rank = rank
        self.world_size = world_size
        self._interval = heartbeat_interval
        self._timeout = heartbeat_timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._beat()

        def loop():
            while not self._stop.wait(self._interval):
                self._beat()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def _beat(self):
        self._store.set(f"__hb/{self.rank}", str(time.time()))

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def dead_ranks(self) -> List[int]:
        now = time.time()
        dead = []
        for r in range(self.world_size):
            v = self._store.get(f"__hb/{r}")
            if v is None or now - float(v) > self._timeout:
                dead.append(r)
        return dead

    def all_alive(self) -> bool:
        return not self.dead_ranks()


def parse_np(np_arg: Optional[str]):
    """``--np`` elastic bounds: "N" (fixed) or "min:max" (reference:
    fleet/elastic/manager.py — np range enables scale-in/out)."""
    if np_arg is None:
        return None
    if ":" in np_arg:
        lo, hi = np_arg.split(":", 1)
        lo, hi = int(lo), int(hi)
    else:
        lo = hi = int(np_arg)
    if not (1 <= lo <= hi):
        raise ValueError(f"--np must satisfy 1 <= min <= max, got {np_arg}")
    return lo, hi


def launch(script: str, script_args: Optional[List[str]] = None,
           nproc_per_node: int = 1, master: Optional[str] = None,
           max_restarts: int = 0, log_dir: Optional[str] = None,
           node_rank: int = 0, nnodes: int = 1,
           np_range: Optional[tuple] = None,
           max_resumes: Optional[int] = None,
           max_resizes: Optional[int] = None) -> int:
    """Spawn ``nproc_per_node`` trainer processes with reference-compatible
    env (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_MASTER) and
    restart-on-failure up to ``max_restarts`` (elastic relaunch); returns
    the job's exit code.

    Single-node (``master=None``): this launcher hosts the TCPStore.
    Multi-node: ``master`` is ``host:port``; the ``node_rank == 0`` launcher
    binds the store at that port, every other node connects to it as a
    client, so all trainers rendezvous against ONE store. Trainer ranks are
    GLOBAL: ``node_rank * nproc_per_node + local`` out of
    ``nnodes * nproc_per_node``.

    Elastic restarts are coordinated cluster-wide through a shared
    ``__restart_epoch`` counter: any launcher whose local trainers fail
    bumps it; every launcher polls it and restarts its trainers when it
    moves. Rendezvous keys (store barriers) are namespaced by the epoch
    (PADDLE_RESTART_EPOCH), so an attempt can never consume a previous
    attempt's stale keys — no cross-node key deletion is needed.

    ``np_range = (min, max)`` turns on SCALE-IN/OUT (reference:
    fleet/elastic/manager.py np-range decision logic, single-node scope
    here): a dead trainer no longer costs a same-size full restart — the
    launcher recomputes the world as the surviving count (>= min) and
    pushes it to the trainers through rewritten env (PADDLE_TRAINER_ID /
    PADDLE_TRAINERS_NUM / PADDLE_RESTART_EPOCH), relaunching at the
    smaller size without failing the job. When capacity
    returns, bumping the ``__scale_out`` store counter (a replacement
    worker announcing itself — or an operator) triggers one more
    membership change back up to max. Below min the job fails. Scale
    events do not consume the ``max_restarts`` crash budget.

    PREEMPTION: trainers exiting with ``RESUMABLE_EXIT_CODE`` committed
    a final checkpoint first — the launcher waits (bounded) for the
    coordinated exit of all ranks, then relaunches WITHOUT consuming
    ``max_restarts``; the relaunched trainers resume from
    ``latest_step``. ``max_resumes`` (default 8) bounds the loop — past
    it the launcher itself exits with the resumable code, surfacing "this
    job keeps getting preempted" to the operator. ``max_resizes``
    (default 8) bounds the coordinated resize relaunches alike.
    """
    resume_budget = _DEFAULT_BUDGET if max_resumes is None \
        else int(max_resumes)
    resize_budget = _DEFAULT_BUDGET if max_resizes is None \
        else int(max_resizes)
    script_args = script_args or []
    np_min, np_max = np_range if np_range else (None, None)
    if np_range and np_min == np_max:
        # fixed --np N: plain process count, works everywhere
        if nproc_per_node not in (1, np_max):
            raise ValueError(
                f"--np {np_max} conflicts with --nproc_per_node "
                f"{nproc_per_node}")
        nproc_per_node = np_max
        np_range = None
    elif np_range is not None:
        if nproc_per_node != 1:
            raise ValueError(
                "--np min:max and --nproc_per_node are mutually "
                "exclusive: the elastic range sets the process count")
        if nnodes == 1:
            nproc_per_node = np_max
        elif np_max != nnodes:
            raise ValueError(
                f"multi-node elastic: --np max ({np_max}) must equal "
                f"--nnodes ({nnodes}) — one trainer per host (one "
                "trainer a launcher); min bounds the surviving node count")
    world_size = nnodes * nproc_per_node
    if master is None:
        store = TCPStore(is_master=True, world_size=world_size)
        master_addr = f"127.0.0.1:{store.port}"
    else:
        master_addr = master
        mhost, mport = master.rsplit(":", 1)
        store = TCPStore(host=mhost, port=int(mport),
                         is_master=(node_rank == 0),
                         world_size=world_size)
    def run() -> int:
        def _exit(code: int) -> int:
            # the store-hosting launcher must be last out: peers may be mid-
            # poll against it. Everyone acks exit; the host waits (bounded)
            # for all acks before returning, since returning drops the store
            # and stops the server.
            try:
                store.add("__exit_ack", 1)
                if store._server:
                    deadline = time.monotonic() + 15
                    while int(store.add("__exit_ack", 0)) < nnodes and \
                            time.monotonic() < deadline:
                        time.sleep(0.1)
            except (OSError, RuntimeError):
                pass
            return code

        if np_range is not None and nnodes > 1:
            return _elastic_multinode(script, script_args, master_addr, store,
                                      nnodes, node_rank, np_min, np_max,
                                      max_restarts, log_dir, resume_budget)

        epoch = int(store.add("__restart_epoch", 0))
        attempts = 0  # local relaunch budget (epoch can over-bump on races)
        resumes = 0   # preemption relaunch budget (separate from crashes)
        resizes = 0   # consensus resize count (separate from both budgets)
        resize_relaunch = False  # next relaunch gap bins `reshard`, not
                                 # `restart` (planned membership change)
        cur_np = nproc_per_node  # this epoch's local trainer count (elastic)
        scale_seen = int(store.add("__scale_out", 0))
        down_at = None  # when the previous attempt's trainers were all dead
        while True:
            cur_world = nnodes * cur_np
            procs = []
            logs = []
            for local in range(cur_np):
                rank = node_rank * cur_np + local
                env = dict(os.environ)
                env.update({
                    "PADDLE_TRAINER_ID": str(rank),
                    "PADDLE_TRAINERS_NUM": str(cur_world),
                    "PADDLE_LOCAL_RANK": str(local),
                    "PADDLE_NODE_RANK": str(node_rank),
                    "PADDLE_MASTER": master_addr,
                    "PADDLE_STORE_PORT": str(store.port),
                    "PADDLE_RESTART_EPOCH": str(epoch),
                })
                if down_at is not None:
                    # relaunch: stamp the previous incarnation's death time
                    # so the child's GoodputLedger bins the gap — `reshard`
                    # after a planned membership change (scale/resize),
                    # `restart` badput otherwise
                    env["PADDLE_TPU_GOODPUT_RESIZE_AT" if resize_relaunch
                        else "PADDLE_TPU_GOODPUT_DOWN_AT"] = repr(down_at)
                if log_dir:
                    os.makedirs(log_dir, exist_ok=True)
                    lf = open(os.path.join(log_dir, f"worker.{rank}.log"), "w")
                    logs.append(lf)
                    out = lf
                else:
                    out = None
                procs.append(subprocess.Popen(
                    [sys.executable, script, *script_args], env=env,
                    stdout=out, stderr=subprocess.STDOUT if out else None))

            # supervise: watch local procs, the cluster restart epoch, and
            # (elastic) the scale-out request counter
            fail_code = None
            scale_event = None  # "in" | "out"
            resume_event = False
            resize_event = False
            resize_relaunch = False  # consumed by the spawn above
            while True:
                codes = [p.poll() for p in procs]
                if any(c == RESIZE_EXIT_CODE for c in codes) and \
                        all(c in (None, 0, RESIZE_EXIT_CODE) for c in codes):
                    # consensus resize boundary (resilience.elastic): ranks
                    # exiting 83 DEPARTED at an agreed step — a membership
                    # change, never a crash. Distinguish the two flavors
                    # within a short window: survivors still RUNNING (or
                    # finished already, exit 0) means an in-place resize
                    # (they hold the full state — just retire the departed
                    # lanes and keep supervising); every rank exiting 83
                    # means a coordinated resize-relaunch at the agreed
                    # world size. (The reference relaunches a survivor that
                    # finishes inside the window as well.)
                    deadline = time.monotonic() + _RESIZE_GRACE
                    while any(p.poll() is None for p in procs) and \
                            time.monotonic() < deadline:
                        time.sleep(0.1)
                    codes = [p.poll() for p in procs]
                    if any(c is None or c == 0 for c in codes):
                        keep_p, keep_l = [], []
                        for i, p in enumerate(procs):
                            if p.poll() == RESIZE_EXIT_CODE:
                                if logs:
                                    logs[i].close()
                            else:
                                keep_p.append(p)
                                if logs:
                                    keep_l.append(logs[i])
                        procs, logs = keep_p, keep_l
                        cur_np = len(procs)
                        resizes += 1
                        continue
                    if all(c == RESIZE_EXIT_CODE for c in codes):
                        resize_event = True
                        if int(store.add("__restart_epoch", 0)) == epoch:
                            store.add("__restart_epoch", 1)
                        break
                    # else: a real crash raced the boundary — fall through
                if any(c not in (None, 0) for c in codes):
                    nonzero = [c for c in codes if c not in (None, 0)]
                    if all(c == RESUMABLE_EXIT_CODE for c in nonzero):
                        # preempted trainers coordinate a final blocking save
                        # and exit together — give the stragglers a bounded
                        # window before deciding this was a resumable stop
                        deadline = time.monotonic() + _RESUME_GRACE
                        while any(p.poll() is None for p in procs) and \
                                time.monotonic() < deadline:
                            time.sleep(0.1)
                        codes = [p.poll() for p in procs]
                        if all(c in (0, RESUMABLE_EXIT_CODE) for c in codes):
                            resume_event = True
                            if int(store.add("__restart_epoch", 0)) == epoch:
                                store.add("__restart_epoch", 1)
                            break
                    fail_code = next(
                        (c for c in codes
                         if c not in (None, 0, RESUMABLE_EXIT_CODE)),
                        RESUMABLE_EXIT_CODE)
                    if np_range:
                        survivors = sum(1 for c in codes if c is None)
                        if survivors >= np_min:
                            # scale-in: continue smaller instead of failing
                            scale_event = "in"
                            cur_np = survivors
                            fail_code = None
                    # signal the whole cluster (idempotent-enough: concurrent
                    # failers over-bump, launchers re-read the counter below)
                    if int(store.add("__restart_epoch", 0)) == epoch:
                        store.add("__restart_epoch", 1)
                    break
                if all(c == 0 for c in codes):
                    break
                if int(store.add("__restart_epoch", 0)) > epoch:
                    break  # another node requested a restart
                if np_range:
                    bumped = int(store.add("__scale_out", 0))
                    if bumped > scale_seen:
                        # absorb the announcement even at full size — a stale
                        # bump must not fire a spurious scale-out after the
                        # next scale-in
                        scale_seen = bumped
                        if cur_np < np_max:
                            # replacement capacity announced: grow to max
                            scale_event = "out"
                            cur_np = np_max
                            if int(store.add("__restart_epoch", 0)) == epoch:
                                store.add("__restart_epoch", 1)
                            break
                time.sleep(0.2)

            if fail_code is None and scale_event is None and not resume_event \
                    and not resize_event \
                    and int(store.add("__restart_epoch", 0)) > epoch:
                # a PEER bumped the epoch before our own trainers' exit codes
                # were read. If this epoch carries a preemption verdict (the
                # consensus stop key the listeners publish), our trainers are
                # mid-final-save and about to exit resumable: give them the
                # grace window and classify the event as a resume, not a
                # crash that eats max_restarts
                try:
                    preempt_verdict = store.get(
                        preempt_stop_key(epoch)) is not None
                except (OSError, RuntimeError):
                    preempt_verdict = False
                if preempt_verdict:
                    deadline = time.monotonic() + _RESUME_GRACE
                    while any(p.poll() is None for p in procs) and \
                            time.monotonic() < deadline:
                        time.sleep(0.1)
                    codes = [p.poll() for p in procs]
                    if codes and any(c == RESUMABLE_EXIT_CODE for c in codes) \
                            and all(c in (0, RESUMABLE_EXIT_CODE)
                                    for c in codes):
                        resume_event = True

            _kill(procs)
            down_at = time.time()  # goodput restart-gap stamp for relaunch
            for lf in logs:
                lf.close()

            final_codes = [p.returncode for p in procs]
            if not resume_event and final_codes and \
                    any(c == RESUMABLE_EXIT_CODE for c in final_codes) and \
                    all(c in (0, RESUMABLE_EXIT_CODE) for c in final_codes):
                # every trainer ultimately left cleanly or resumable: this was
                # a coordinated preemption stop regardless of what the
                # supervise loop concluded mid-flight (a straggler's blocking
                # final save outlasting the grace window can masquerade as a
                # scale-in or crash) — resume at FULL size, spend the resume
                # budget, leave max_restarts alone
                resume_event = True
                scale_event = None
                fail_code = None
                cur_np = len(procs)

            new_epoch = int(store.add("__restart_epoch", 0))
            if resize_event:
                # coordinated resize-relaunch (resilience.elastic): every
                # rank left at the agreed boundary — relaunch at the agreed
                # world size, stamping the gap into the goodput `reshard` bin
                # (PADDLE_TPU_GOODPUT_RESIZE_AT) and spending only the
                # max_resizes budget, never max_restarts/resumes
                resizes += 1
                if resizes > resize_budget:
                    return _exit(RESIZE_EXIT_CODE)
                tgt = _resize_target_world(store, epoch)
                if tgt is not None:
                    start = node_rank * cur_np
                    new_local = max(0, min(cur_np, tgt - start))
                    if new_local == 0:
                        return _exit(0)  # every rank of this host departed
                    cur_np = new_local
                resize_relaunch = True
                if new_epoch == epoch:
                    store.add("__restart_epoch", 1)
                    new_epoch = int(store.add("__restart_epoch", 0))
                epoch = new_epoch
                continue
            if resume_event:
                # preemption stop, checkpoint committed: relaunch (trainers
                # resume from latest_step) without consuming max_restarts
                resumes += 1
                if resumes > resume_budget:
                    return _exit(RESUMABLE_EXIT_CODE)
                if new_epoch == epoch:
                    store.add("__restart_epoch", 1)
                    new_epoch = int(store.add("__restart_epoch", 0))
                epoch = new_epoch
                continue
            if scale_event is not None:
                # membership change, not a crash: rewrite env and relaunch the
                # survivors at the new size without consuming max_restarts.
                # The epoch ALWAYS advances through the store counter, so
                # epoch-namespaced rendezvous keys can never be reused.
                resize_relaunch = True  # goodput: a resize, not a restart
                if new_epoch == epoch:
                    store.add("__restart_epoch", 1)
                    new_epoch = int(store.add("__restart_epoch", 0))
                epoch = new_epoch
                continue
            if fail_code is None and new_epoch == epoch:
                # clean local exit — but a peer may still fail and request a
                # restart; leaving now would also tear down the master store
                # under the cluster. Publish done and leave only when every
                # node finished this epoch cleanly (or a restart is requested).
                store.set(f"__done/{epoch}/{node_rank}", b"1")
                while True:
                    new_epoch = int(store.add("__restart_epoch", 0))
                    if new_epoch != epoch:
                        break
                    if all(store.get(f"__done/{epoch}/{n}") is not None
                           for n in range(nnodes)):
                        return _exit(0)
                    time.sleep(0.2)
            attempts += 1
            if attempts > max_restarts:
                return _exit(fail_code if fail_code is not None else 1)
            epoch = new_epoch

    try:
        return run()
    finally:
        store.close()


_LHB_INTERVAL = 0.5    # launcher heartbeat period (s)
_LHB_TIMEOUT = 4.0     # peer launcher declared dead after this silence
_SETTLE = 2.0          # membership join window per epoch
_BOOT_TIMEOUT = 30.0   # wait this long for an under-min join set (cold
                       # start pod stagger) before aborting the job
_CLAIM_TIMEOUT = 40.0  # a won-but-unpublished claim (claimer died mid-
                       # decision) is abandoned by bumping the epoch; must
                       # exceed _BOOT_TIMEOUT so the abort can fire first


def _elastic_multinode(script, script_args, master_addr, store, nnodes,
                       node_rank, np_min, np_max, max_restarts, log_dir,
                       resume_budget=8):
    """Cluster-wide elastic membership (reference:
    fleet/elastic/manager.py:126 — etcd-leased node registry with a leader
    deciding the world; here the TCPStore is the registry).

    Per epoch: every live launcher registers ``__join/{epoch}/{node}``,
    the LOWEST-rank joiner (with an atomic-claim fallback should it die
    mid-decision) publishes the verdict ``__world/{epoch}`` = the member
    list; members spawn one trainer each with contiguous re-ranked
    PADDLE_TRAINER_ID. Launchers heartbeat ``__lhb/{node}``; a stale
    member heartbeat or a local trainer failure bumps the shared epoch,
    driving a new membership round — survivors >= min continue smaller
    (scale-in). A late/re-started launcher whose join missed the verdict
    announces itself through ``__scale_out`` and is absorbed by the next
    round (scale-out). Scale events never consume ``max_restarts``; only
    local trainer crashes do."""
    try:
        return _elastic_multinode_loop(
            script, script_args, master_addr, store, nnodes, node_rank,
            np_min, np_max, max_restarts, log_dir, resume_budget)
    except (ConnectionError, OSError) as e:
        # only claim "store lost" when the store actually IS unreachable —
        # a FileNotFoundError from Popen or a log-dir PermissionError must
        # keep its traceback, not masquerade as a network failure
        try:
            store.get("__probe")
        except (OSError, RuntimeError):
            print(f"[elastic] job store lost ({e!r}) — the store-hosting "
                  "launcher is gone; failing this node", file=sys.stderr)
            return 1
        raise


def _elastic_multinode_loop(script, script_args, master_addr, store,
                            nnodes, node_rank, np_min, np_max,
                            max_restarts, log_dir, resume_budget=8):
    epoch = int(store.add("__restart_epoch", 0))
    scale_seen = int(store.add("__scale_out", 0))
    attempts = 0
    resumes = 0

    def mn_exit(code, cur_epoch, members):
        """Membership-scoped exit sync: acks are keyed by (epoch, node) so
        a dead launcher's ack from an OLD membership can never satisfy the
        store host's wait and tear the store down under a replacement
        launcher still using it. The store-hosting node waits (bounded)
        for the FINAL epoch's members; a host crash-exit still ends the
        job — the store is the rendezvous, like the reference's etcd."""
        try:
            store.set(f"__exit_ack/{cur_epoch}/{node_rank}", b"1")
            if store._server:
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline and not all(
                        store.get(f"__exit_ack/{cur_epoch}/{n}")
                        is not None for n in members):
                    time.sleep(0.1)
        except (OSError, RuntimeError):
            pass
        return code

    def beat():
        store.set(f"__lhb/{node_rank}", str(time.time()).encode())

    def bump_if_current(e):
        if int(store.add("__restart_epoch", 0)) == e:
            store.add("__restart_epoch", 1)

    def wait_next_epoch(e):
        while int(store.add("__restart_epoch", 0)) == e:
            beat()
            time.sleep(0.2)
        return int(store.add("__restart_epoch", 0))

    down_at = None  # when the previous round's trainer died (goodput)
    resize_relaunch = False  # next round's gap bins `reshard` (planned)
    while True:
        beat()
        store.set(f"__join/{epoch}/{node_rank}", b"1")

        # settle window: fast-path out when every possible node joined
        t0 = time.monotonic()
        while time.monotonic() - t0 < _SETTLE:
            if all(store.get(f"__join/{epoch}/{n}") is not None
                   for n in range(nnodes)):
                break
            time.sleep(0.1)

        verdict_key = f"__world/{epoch}"
        t_claim = time.monotonic()
        stale_epoch = False
        while store.get(verdict_key) is None:
            if int(store.add("__restart_epoch", 0)) > epoch:
                # round superseded (e.g. a wedged claim was abandoned by a
                # peer bumping the epoch) — re-join at the new one
                stale_epoch = True
                break
            elapsed = time.monotonic() - t_claim
            joined = [n for n in range(nnodes)
                      if store.get(f"__join/{epoch}/{n}") is not None]
            lowest = joined and joined[0] == node_rank
            fallback = elapsed > 2 * _SETTLE
            if (lowest or fallback) and len(joined) >= np_min and \
                    int(store.add(f"__claim/{epoch}", 1)) == 1:
                # decide only with quorum: at cold start launchers may
                # join many seconds apart (pod stagger) — an under-min
                # join set WAITS (up to _BOOT_TIMEOUT) instead of
                # aborting a job that is one second from healthy
                store.set(verdict_key,
                          ",".join(map(str, joined)).encode())
            if elapsed > _BOOT_TIMEOUT and len(joined) < np_min and \
                    int(store.add(f"__claim/{epoch}", 1)) == 1:
                store.set(verdict_key, b"__abort")
            if elapsed > _CLAIM_TIMEOUT:
                # a claimer won __claim then died before publishing: no
                # verdict can ever appear for THIS epoch — abandon it
                # (fresh epoch = fresh claim key, the wedge clears)
                bump_if_current(epoch)
            beat()
            time.sleep(0.1)
        if stale_epoch:
            epoch = int(store.add("__restart_epoch", 0))
            continue
        verdict = store.get(verdict_key)
        if verdict == b"__abort":
            # drain acks from every launcher that saw this round, so the
            # store host doesn't drop the server mid-poll under peers
            joined = [n for n in range(nnodes)
                      if store.get(f"__join/{epoch}/{n}") is not None]
            return mn_exit(1, epoch, joined)
        members = [int(x) for x in verdict.decode().split(",")]
        world = len(members)

        if node_rank not in members:
            # our join missed this epoch's verdict: we ARE the replacement
            # capacity — announce and fold into the next round
            store.add("__scale_out", 1)
            scale_seen = int(store.add("__scale_out", 0))
            epoch = wait_next_epoch(epoch)
            continue

        rank = members.index(node_rank)
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_LOCAL_RANK": "0",
            "PADDLE_NODE_RANK": str(node_rank),
            "PADDLE_MASTER": master_addr,
            "PADDLE_STORE_PORT": str(store.port),
            "PADDLE_RESTART_EPOCH": str(epoch),
        })
        if down_at is not None:
            # relaunch round: stamp the previous trainer's death time for
            # the child's goodput accounting — `reshard` after a planned
            # membership change, `restart` otherwise
            env["PADDLE_TPU_GOODPUT_RESIZE_AT" if resize_relaunch
                else "PADDLE_TPU_GOODPUT_DOWN_AT"] = repr(down_at)
        resize_relaunch = False
        lf = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            # epoch-scoped name: the previous epoch's log holds the crash
            # that CAUSED this round — never truncate it
            lf = open(os.path.join(
                log_dir, f"worker.n{node_rank}.e{epoch}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, script, *script_args], env=env, stdout=lf,
            stderr=subprocess.STDOUT if lf else None)

        fail_code = None
        last_beat = 0.0
        grace = time.monotonic() + _LHB_TIMEOUT  # peers re-join slowly
        # staleness by VALUE-change observation on the reader's monotonic
        # clock: cross-host wall-clock arithmetic would declare a
        # skewed-NTP peer dead forever and churn restarts
        lhb_seen: dict = {}

        def lhb_stale(n: int) -> bool:
            v = store.get(f"__lhb/{n}")
            if v is None:
                return False  # never beat: still booting, not dead
            prev = lhb_seen.get(n)
            mono = time.monotonic()
            if prev is None or prev[0] != v:
                lhb_seen[n] = (v, mono)
                return False
            return mono - prev[1] > _LHB_TIMEOUT

        while True:
            now = time.monotonic()
            if now - last_beat >= _LHB_INTERVAL:
                beat()
                last_beat = now
            code = proc.poll()
            if code not in (None, 0):
                fail_code = code
                bump_if_current(epoch)
                break
            if code == 0:
                break
            if int(store.add("__restart_epoch", 0)) > epoch:
                break  # cluster-wide membership change requested
            bumped = int(store.add("__scale_out", 0))
            if bumped > scale_seen:
                scale_seen = bumped
                if world < np_max:
                    resize_relaunch = True  # planned membership growth
                    bump_if_current(epoch)
                    break
            if now > grace:
                # a host that DEPARTED at a consensus resize boundary
                # stops beating on purpose — never read that as a death
                stale = [n for n in members if n != node_rank
                         and lhb_stale(n) and
                         store.get(f"__departed/{epoch}/{n}") is None]
                if stale:
                    bump_if_current(epoch)
                    break
            time.sleep(0.2)

        _kill([proc])
        down_at = time.time()  # goodput restart-gap stamp for relaunch
        if lf:
            lf.close()

        if proc.returncode == RESIZE_EXIT_CODE:
            # this host's rank departed at a consensus resize boundary
            # (resilience.elastic): the surviving members carry the full
            # state and continue IN PLACE. Mark the departure (so peers
            # don't read our stopping heartbeat as a death) and leave the
            # job cleanly — no epoch bump, no budget spent.
            try:
                store.set(f"__departed/{epoch}/{node_rank}", b"1")
            except (OSError, RuntimeError):
                pass
            return mn_exit(0, epoch, [])

        if fail_code is None and proc.returncode == 0 and \
                int(store.add("__restart_epoch", 0)) == epoch:
            # clean local exit: leave when every MEMBER finished this
            # epoch (or a membership change supersedes it)
            store.set(f"__done/{epoch}/{node_rank}", b"1")
            while True:
                beat()
                if int(store.add("__restart_epoch", 0)) != epoch:
                    break
                bumped = int(store.add("__scale_out", 0))
                if bumped > scale_seen and world < np_max:
                    # a replacement announced itself during completion:
                    # run one more round at the bigger size instead of
                    # exiting and tearing the store down under it
                    scale_seen = bumped
                    resize_relaunch = True
                    bump_if_current(epoch)
                    break
                if all(store.get(f"__done/{epoch}/{n}") is not None or
                       store.get(f"__departed/{epoch}/{n}") is not None
                       for n in members):
                    return mn_exit(0, epoch, members)
                time.sleep(0.2)

        if fail_code == RESUMABLE_EXIT_CODE:
            # preempted-with-checkpoint (resilience contract): rejoin the
            # next membership round without consuming the crash budget
            resumes += 1
            if resumes > resume_budget:
                return mn_exit(RESUMABLE_EXIT_CODE, epoch, [])
        elif fail_code is not None:
            attempts += 1
            if attempts > max_restarts:
                # exit immediately: surviving members are CONTINUING (they
                # rejoin the next round), so waiting for their exit acks
                # would only stall 15 s. If this node hosts the store the
                # job dies with it — the store IS the rendezvous
                # (reference analog: losing etcd fails the job)
                return mn_exit(fail_code, epoch, [])
        new_epoch = int(store.add("__restart_epoch", 0))
        if new_epoch == epoch:  # ensure forward progress
            store.add("__restart_epoch", 1)
            new_epoch = int(store.add("__restart_epoch", 0))
        epoch = new_epoch


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch distributed trainer processes")
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--master", type=str, default=None)
    parser.add_argument("--max_restarts", type=int, default=0)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--np", type=str, default=None, dest="np_arg",
                        help="elastic trainer-count bounds: N or min:max "
                             "(reference fleet/elastic --np)")
    parser.add_argument("--max_resumes", type=int, default=None,
                        help="preemption relaunch budget (trainers exiting "
                             "with the resumable code; default 8)")
    parser.add_argument("--max_resizes", type=int, default=None,
                        help="coordinated resize relaunch budget (trainers "
                             "exiting with the resize code; default 8)")
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return launch(args.script, args.script_args, args.nproc_per_node,
                  args.master, args.max_restarts, args.log_dir,
                  args.node_rank, args.nnodes,
                  np_range=parse_np(args.np_arg),
                  max_resumes=args.max_resumes,
                  max_resizes=args.max_resizes)


if __name__ == "__main__":
    sys.exit(main())
