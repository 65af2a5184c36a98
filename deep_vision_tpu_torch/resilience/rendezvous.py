"""File-backed membership with leases and generations (the port of
deep_vision_tpu/resilience/rendezvous.py, its `Rendezvous` and what it
raises).

Members of a world share a directory. Each member keeps a lease: a
record it rewrites every heartbeat, which the others read; a record
older than the lease (three beats by default) is a dead member, named
by `HostLostError` within that deadline rather than by a hang. A world
is versioned by a generation number: the leader (the lowest live,
version-compatible member) writes `gen/<g>.json` with O_EXCL, so
exactly one record wins a generation, and every listed member acks it
at a barrier before going on. Joiners whose client or platform versions
disagree with the majority's are refused at join with kind
`version_skew`. Barriers and `agree` (a global OR) are
deadline-bounded and lease-checked.

The process fleet (serve/procpool.py) runs each replica as a member:
the first cohort forms a generation with `join`, a respawned replica
re-enters it with `attach`, and the parent reads the leases
(`lease_gap`) to tell a hung replica from a live one.

The records on disk are the reference's, byte for byte in layout and
keys, so the two packages' members can share one directory. Stdlib
only. One difference: `lease_gap` reads the clock before the record,
where the reference reads it after sweeping every member record, so a
reader whose threads wait on its GIL (a fleet parent encoding
requests) read a live member's lease as expired. The reference's `HostSupervisor`, which re-executes a training
host into a new generation, belongs to elastic training and is not
ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from deep_vision_tpu_torch.core import knobs

#: refusal kinds carried by RendezvousRefused
REFUSAL_VERSION_SKEW = "version_skew"
REFUSAL_EVICTED = "evicted"

#: env var naming the generation `attach()` re-enters when given none
ENV_GENERATION = "DVT_RDZV_GENERATION"


class RendezvousError(RuntimeError):
    """Base for rendezvous-layer failures."""


class HostLostError(RendezvousError):
    """A member's lease expired (or a collective deadline passed): the
    typed form of what would otherwise be an indefinite hang. `host` is
    the dead member's id (None when only the deadline fired and the
    lease ledger cannot name the peer)."""

    def __init__(self, host: Optional[str], generation: int,
                 detail: str = "", lease_gap_s: Optional[float] = None):
        self.host = host
        self.generation = int(generation)
        self.lease_gap_s = lease_gap_s
        msg = (f"host {host!r} lost at generation {generation}"
               if host is not None else
               f"peer unresponsive at generation {generation}")
        super().__init__(msg + (f": {detail}" if detail else ""))


class RendezvousTimeout(RendezvousError):
    """A join/resize/barrier deadline passed with every known member
    still alive — the world never assembled (wrong --expect-hosts, a
    host that never launched)."""


class RendezvousRefused(RendezvousError):
    """This host was refused admission (kind `version_skew`: its
    client/platform versions disagree with the incumbent world's,
    caught at join in seconds; kind `evicted`: a generation formed
    without it)."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        super().__init__(f"rendezvous refused [{kind}]"
                         + (f": {detail}" if detail else ""))


class WorldResized(RendezvousError):
    """Control-flow signal, not a failure: the world moved to a new
    generation and this process must re-enter it (tear down its process
    group, rebuild, resume from a checkpoint)."""

    def __init__(self, view: "WorldView", resume_step: Optional[int] = None):
        self.view = view
        self.resume_step = resume_step
        super().__init__(
            f"world resized to generation {view.generation} "
            f"({view.world_size} host(s)); resume_step={resume_step}")


@dataclasses.dataclass(frozen=True)
class WorldView:
    """One generation's membership, as seen by one host.

    `hosts` is the generation record's member-id tuple IN RECORD ORDER:
    the generation leader first (rank 0 must be the host that allocated
    — and can actually bind — the coordinator address in the record),
    then the rest sorted. A host's rank is its index — dense,
    deterministic, and re-derived per generation, so a host-sharded
    input pipeline re-derives a disjoint and covering assignment after
    an N→M resize.
    """

    generation: int
    hosts: Tuple[str, ...]
    host: str
    coordinator: Optional[str] = None  # "host:port" of rank 0's store

    @property
    def world_size(self) -> int:
        return len(self.hosts)

    @property
    def rank(self) -> int:
        return self.hosts.index(self.host)

    def shard(self) -> Tuple[int, int]:
        """(shard_index, num_shards) for host-sharded input
        pipelines."""
        return self.rank, self.world_size

    def to_dict(self) -> dict:
        return {"generation": self.generation, "hosts": list(self.hosts),
                "host": self.host, "coordinator": self.coordinator}


def _atomic_write(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        # mid-rename read or a torn writer: treat as absent, the poll
        # loop re-reads
        return None


def free_port(host: str = "127.0.0.1") -> int:
    """A free TCP port on `host` — the generation leader allocates the
    coordinator's port here (the leader IS rank 0, so the port is
    allocated on the machine that will bind it)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def versions_compatible(mine: Dict[str, str],
                        theirs: Dict[str, str]) -> Tuple[bool, str]:
    """The join-time version handshake, as a pure function.

    Compares `client_version` (the framework's version) and
    `platform_version` (the device runtime's build string) field by
    field; a field one side did not report is not a
    mismatch (heterogeneous probes must not fail closed on missing
    introspection). Returns (ok, detail)."""
    for key in ("client_version", "platform_version"):
        a, b = mine.get(key), theirs.get(key)
        if a and b and a != b:
            return False, f"{key} skew: joiner has {a!r}, world has {b!r}"
    return True, ""


class Rendezvous:
    """File-backed, generation-numbered membership for one host.

    Layout under `root` (a shared directory):

        members/<host>.json            lease record, rewritten per heartbeat
        refused/<host>.json            admission refusals (version_skew)
        gen/<g>.json                   generation record (hosts, coordinator),
                                       O_EXCL-created by the generation leader
        barriers/<g>/<name>#<seq>/<host>.json   barrier/agree ballots

    Leadership per generation = the lexicographically lowest live,
    version-compatible member id; the version REFERENCE is the earliest
    joiner still alive (the incumbent world refuses the skewed joiner,
    not the other way around). Barrier names carry a per-name sequence
    counter so the same name may be used repeatedly (every host calls
    the same barriers in the same order, as collectives require).
    """

    def __init__(self, root: str, host: str,
                 heartbeat_s: float = 2.0, lease_s: Optional[float] = None,
                 poll_s: float = 0.05,
                 coordinator_host: str = "127.0.0.1",
                 client_version: Optional[str] = None,
                 platform_version: Optional[str] = None):
        if not host or "/" in host:
            raise ValueError(f"host id must be a non-empty path-safe "
                             f"string, got {host!r}")
        self.root = root
        self.host = host
        self.heartbeat_s = float(heartbeat_s)
        #: a member is dead when its record is older than this (3 beats
        #: by default: one lost write is jitter, three is a corpse)
        self.lease_s = float(lease_s) if lease_s is not None \
            else 3.0 * self.heartbeat_s
        self.poll_s = float(poll_s)
        self.coordinator_host = coordinator_host
        self.versions = {}
        if client_version:
            self.versions["client_version"] = str(client_version)
        if platform_version:
            self.versions["platform_version"] = str(platform_version)
        self.generation = -1  # no world yet
        self.view: Optional[WorldView] = None
        self._joined_ts = time.time()  # join() restamps at the real join
        # when a version disagreement is only a TIEBREAK loss (equal
        # compatibility scores), self-refusal waits this long for more
        # voters: a correct host polling in the instant before its peers'
        # member records land must not be poisoned by a stale
        # first-writer. A genuine 1-vs-1 skew still refuses within ~2
        # heartbeats — seconds, not the join deadline.
        self._tie_grace_s = 2.0 * self.heartbeat_s
        self._tie_since: Optional[float] = None
        self._seq: Dict[str, int] = {}
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        for sub in ("members", "refused", "gen", "barriers"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)

    # -- member records ----------------------------------------------------

    def _member_path(self, host: str) -> str:
        return os.path.join(self.root, "members", f"{host}.json")

    def _write_member(self) -> None:
        _atomic_write(self._member_path(self.host), {
            "host": self.host, "pid": os.getpid(), "ts": time.time(),
            "joined_ts": self._joined_ts, **self.versions,
        })

    def members(self) -> Dict[str, dict]:
        """Every member record on disk (alive or stale)."""
        out: Dict[str, dict] = {}
        mdir = os.path.join(self.root, "members")
        for name in sorted(os.listdir(mdir)):
            if not name.endswith(".json") or name.startswith("."):
                continue
            rec = _read_json(os.path.join(mdir, name))
            if rec and rec.get("host"):
                out[str(rec["host"])] = rec
        return out

    def alive(self, now: Optional[float] = None) -> Dict[str, dict]:
        now = time.time() if now is None else now
        return {h: r for h, r in self.members().items()
                if now - float(r.get("ts", 0)) <= self.lease_s}

    def lease_gap(self, host: str) -> Optional[float]:
        """Seconds since `host` last renewed its lease (None without a
        record). The clock is read before the record: a reader slowed
        down (its own GIL held by other threads, a slow shared
        filesystem) must never age a live member's lease past its
        deadline."""
        now = time.time()
        rec = _read_json(self._member_path(host))
        if rec is None:
            return None
        return now - float(rec.get("ts", 0))

    # -- heartbeats --------------------------------------------------------

    def start_heartbeat(self) -> None:
        """Arm the lease: write the member record now (synchronously, so
        the lease exists before this call returns, before the caller's
        slow imports and builds) and keep rewriting it from a daemon
        thread."""
        self._write_member()
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return

        def beat():
            while not self._hb_stop.wait(self.heartbeat_s):
                try:
                    self._write_member()
                except OSError:
                    pass  # a shared-FS hiccup; the next beat retries

        self._hb_stop.clear()
        self._hb_thread = threading.Thread(
            target=beat, name=f"rendezvous-heartbeat-{self.host}",
            daemon=True)
        self._hb_thread.start()

    def touch(self) -> None:
        """One synchronous lease renewal (callers about to exec renew
        right before, shrinking the re-entry gap to the exec itself)."""
        self._write_member()

    def leave(self) -> None:
        """Clean departure: stop heartbeating and drop the member record
        so survivors see an empty slot, not an expiring lease."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2 * self.heartbeat_s)
            self._hb_thread = None
        try:
            os.remove(self._member_path(self.host))
        except OSError:
            pass

    # -- admission (the version handshake) ---------------------------------

    def _refusal_path(self, host: str) -> str:
        return os.path.join(self.root, "refused", f"{host}.json")

    @staticmethod
    def _compat_score(rec: dict, members: Dict[str, dict]) -> int:
        """How many of `members` this record's versions agree with (its
        own record included, when present) — the vote both the reference
        election and the admission tie/majority classification share."""
        return sum(1 for other in members.values()
                   if versions_compatible(rec, other)[0])

    @classmethod
    def _reference_member(cls, members: Dict[str, dict]) -> Optional[dict]:
        """The version reference: the member compatible with the MOST
        members (majority wins — a skewed host that happens to write its
        record first must not poison the whole fleet into self-refusing),
        ties broken toward the earliest joiner (the incumbent rule, which
        is all a 1-vs-1 disagreement has to go on)."""
        if not members:
            return None
        return min(members.values(),
                   key=lambda r: (-cls._compat_score(r, members),
                                  float(r.get("joined_ts", 0)),
                                  str(r.get("host"))))

    def _check_admission(self, alive: Optional[Dict[str, dict]] = None
                         ) -> None:
        """Raise RendezvousRefused if the majority world's versions
        disagree with ours, or if a still-applicable refusal marker
        stands against us. `alive`: a LIVE-members snapshot from this
        poll iteration (the join loop reads the member directory once
        per pass and shares it) — corpses must not vote: a dead fleet's
        stale records outnumbering the fresh one would otherwise elect
        a corpse as the version reference and make every healthy host
        self-refuse."""
        refusal = _read_json(self._refusal_path(self.host))
        if refusal:
            # a refusal is pinned to the VERSIONS it judged: a host the
            # operator has since upgraded to match the fleet must be
            # able to rejoin under the same id — the stale marker is
            # retired, not honored forever
            if refusal.get("versions", None) in (None, self.versions):
                # a refused host drops its lease, as the self-refusal
                # below does: a record that kept beating would stay the
                # earliest joiner of its id and, elected the version
                # reference, refuse the fleet's own hosts (the reference
                # raises here with its heartbeat still running)
                self.leave()
                raise RendezvousRefused(
                    str(refusal.get("kind", "refused")),
                    str(refusal.get("detail", "")))
            try:
                os.remove(self._refusal_path(self.host))
            except OSError:
                pass
        members = alive if alive is not None else self.alive()
        # the electorate always includes THIS host: the sweep can lag our
        # own member-record write (first poll, NFS/GCS listing delay),
        # and without our self-vote a single stale first-writer would
        # read as a strict majority and refuse us instantly — bypassing
        # the very grace window below
        electorate = dict(members)
        electorate.setdefault(self.host, {
            "host": self.host, "joined_ts": self._joined_ts,
            **self.versions})
        ref = self._reference_member(electorate)
        if ref is None or str(ref.get("host")) == self.host:
            self._tie_since = None
            return
        ok, detail = versions_compatible(self.versions, ref)
        if ok:
            self._tie_since = None
            return
        # the reference disagrees with us. A STRICT-majority reference
        # refuses immediately; a reference that won only the
        # earliest-joiner tiebreak (equal scores) gets a grace window —
        # during assembly the tie is usually transient (our compatible
        # peers' member records are milliseconds from landing), and
        # self-refusing on it would let one stale first-writer poison
        # every correct host (the majority-vote rationale, extended to
        # the race the vote itself has before all voters are visible)
        mine = electorate[self.host]
        if self._compat_score(ref, electorate) \
                <= self._compat_score(mine, electorate):
            now = time.time()
            if self._tie_since is None:
                self._tie_since = now
            if now - self._tie_since < self._tie_grace_s:
                return  # wait for more voters before condemning anyone
        # self-refusal is the fast path; also leave the marker so
        # the ledger shows WHY this host never made a generation
        _atomic_write(self._refusal_path(self.host), {
            "host": self.host, "kind": REFUSAL_VERSION_SKEW,
            "detail": detail, "versions": self.versions,
            "ts": time.time()})
        self.leave()
        raise RendezvousRefused(REFUSAL_VERSION_SKEW, detail)

    def _compatible(self, members: Dict[str, dict]) -> Dict[str, dict]:
        """Members whose versions agree with the majority reference (the
        leader forms generations from these only; a skewed member that
        skipped its self-check still never makes a world)."""
        ref = self._reference_member(members)
        if ref is None:
            return {}
        out = {}
        for h, r in members.items():
            ok, detail = versions_compatible(r, ref)
            if ok:
                out[h] = r
            elif not os.path.exists(self._refusal_path(h)):
                _atomic_write(self._refusal_path(h), {
                    "host": h, "kind": REFUSAL_VERSION_SKEW,
                    "detail": detail,
                    "versions": {k: r[k] for k in
                                 ("client_version", "platform_version")
                                 if k in r},
                    "ts": time.time()})
        return out

    # -- generation records ------------------------------------------------

    def _gen_path(self, g: int) -> str:
        return os.path.join(self.root, "gen", f"{g}.json")

    def _write_generation(self, g: int, hosts: Sequence[str]) -> bool:
        """O_EXCL create: exactly one leader wins generation `g`; a loser
        reads the winner's record. Returns True when we wrote it.

        Host order in the record IS the rank order, writer (= leader)
        first: rank 0 of a world must bind the coordinator address,
        and the port below is allocated on THIS machine — a
        lexicographically-lower member (a freshly-admitted joiner, say)
        must not inherit rank 0 and with it an address it cannot bind."""
        hosts = [self.host] + sorted(h for h in hosts if h != self.host)
        rec = {
            "generation": g, "hosts": hosts,
            "coordinator": f"{self.coordinator_host}:"
                           f"{free_port(self.coordinator_host)}",
            "leader": self.host, "ts": time.time(),
        }
        try:
            fd = os.open(self._gen_path(g),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        return True

    def read_generation(self, g: int) -> Optional[dict]:
        return _read_json(self._gen_path(g))

    def latest_generation(self) -> Optional[dict]:
        gdir = os.path.join(self.root, "gen")
        best = None
        for name in os.listdir(gdir):
            if name.endswith(".json"):
                try:
                    g = int(name[:-5])
                except ValueError:
                    continue
                if best is None or g > best:
                    best = g
        return self.read_generation(best) if best is not None else None

    def _adopt(self, rec: dict) -> WorldView:
        hosts = tuple(str(h) for h in rec["hosts"])  # record order IS
        # rank order (leader/coordinator-binder first)
        if self.host not in hosts:
            raise RendezvousRefused(
                REFUSAL_EVICTED,
                f"generation {rec['generation']} formed without this host "
                f"(hosts={list(hosts)}) — its lease must have lapsed")
        self.generation = int(rec["generation"])
        # this host's membership incarnation began no later than the
        # record that lists it: clamp joined_ts so a post-reexec
        # attach's member file still PREDATES the record and
        # _world_running keeps reading the world as live (a replacement
        # joiner must wait for a resize, not squat the next generation)
        rts = float(rec.get("ts", self._joined_ts))
        if rts < self._joined_ts:
            self._joined_ts = rts
            self.touch()
        # barrier sequence numbering is per generation (the dirs are):
        # members enter a generation along different histories — join,
        # in-place resize, post-exec attach — and carried-over counters
        # would split the SAME logical barrier across #k dirs
        self._seq = {}
        self.view = WorldView(generation=self.generation, hosts=hosts,
                              host=self.host,
                              coordinator=rec.get("coordinator"))
        return self.view

    # -- join / attach / resize --------------------------------------------

    def _world_running(self, rec: Optional[dict],
                       alive: Dict[str, dict]) -> bool:
        """Is the latest generation record a LIVE world (vs leftovers)?

        A member of `rec` counts as still running that world only when
        its lease is fresh AND its joined_ts predates the record (the
        same incarnation that formed it). A fleet re-joining over a
        stale directory re-stamps every joined_ts, so yesterday's
        record reads as dead and the new world forms at generation
        latest+1 — which is also how a preflight probe's leftover
        record never squats the directory the real run is about to
        claim."""
        if rec is None:
            return False
        rts = float(rec.get("ts", 0))
        for h in rec.get("hosts", ()):
            m = alive.get(str(h))
            if m is not None and float(m.get("joined_ts", rts + 1)) <= rts:
                return True
        return False

    def join(self, expect_hosts: int, timeout_s: float = 120.0) -> WorldView:
        """Enter a world of exactly `expect_hosts` version-compatible
        members. Deadline-bounded; the version handshake runs on every
        poll so a skewed joiner is refused in seconds, not at the
        deadline.

        Generations need not start at 0: a fresh fleet over a stale
        directory (a previous run's records, a preflight probe's
        leftovers) forms at latest+1. Joining while a world is RUNNING
        never overwrites it — the joiner heartbeats and waits to be
        adopted by the running world's next `resize()` (which includes
        every live compatible member: that is the host_joined/grow
        path)."""
        self._joined_ts = time.time()
        self.start_heartbeat()
        deadline = time.time() + timeout_s
        while True:
            rec = self.latest_generation()
            fresh = (rec is not None
                     and float(rec.get("ts", 0))
                     >= self._joined_ts - self.lease_s)
            if fresh and self.host in {str(h) for h in rec["hosts"]}:
                view = self._adopt(rec)
                self._ack_generation(view, deadline)
                return view
            members = self.members()  # ONE directory sweep per pass,
            now = time.time()         # shared by every sub-check below
            alive = {h: r for h, r in members.items()
                     if now - float(r.get("ts", 0)) <= self.lease_s}
            self._check_admission(alive)  # live members only: a dead
            # fleet's stale records must not out-vote the fresh ones
            compat = self._compatible(alive)
            if (len(compat) >= expect_hosts
                    and not self._world_running(rec, alive)):
                leader = sorted(compat)[0]
                if leader == self.host:
                    g = 0 if rec is None else int(rec["generation"]) + 1
                    self._write_generation(g, sorted(compat)[:expect_hosts])
                    continue  # adopt what we (or a racer) wrote
            if time.time() > deadline:
                self.leave()
                raise RendezvousTimeout(
                    f"world of {expect_hosts} never assembled within "
                    f"{timeout_s:.0f}s (alive+compatible: "
                    f"{sorted(compat)})")
            time.sleep(self.poll_s)

    def attach(self, generation: Optional[int] = None,
               timeout_s: float = 300.0) -> WorldView:
        """Re-enter an existing generation (a respawned member's path;
        `ENV_GENERATION` names it when `generation` is None). Re-arms
        the lease first, then blocks — deadline-bounded — on the attach
        barrier so every member of the generation is live before anyone
        starts a process group (which would otherwise hang on a member
        still starting up)."""
        self._joined_ts = getattr(self, "_joined_ts", time.time())
        self.start_heartbeat()
        if generation is None:
            generation = knobs.get_int(ENV_GENERATION)
        rec = (self.read_generation(generation) if generation is not None
               else self.latest_generation())
        if rec is None:
            raise RendezvousError(
                f"no generation record to attach to "
                f"(generation={generation!r}) under {self.root}")
        view = self._adopt(rec)
        self._ack_generation(view, time.time() + timeout_s)
        return view

    def _ack_generation(self, view: WorldView, deadline: float) -> None:
        """Everyone listed in the generation must ack before any member
        goes on — a listed-but-dead host would otherwise hang the
        distributed handshake. Lease checks are ON: a member dying
        between the record and its ack triggers re-resize, not a hang.
        Generous deadline: an ack may be a whole process start away.
        seq=False: members reach a generation's ack along DIFFERENT call
        paths (join vs resize vs attach), so a per-name sequence counter
        would split them across barrier dirs; one fixed dir per
        generation is the meeting point. A stale ballot of an earlier
        incarnation can at worst let a member go on early, into a
        handshake with its own bounded timeout."""
        self.barrier("gen-ack", timeout_s=max(0.0, deadline - time.time()),
                     scope=view, seq=False)

    def check(self) -> None:
        """Lease sweep over the current generation; raises HostLostError
        for the first expired member. The cheap poll the bounded device
        fences run between waits."""
        if self.view is None:
            return
        alive = self.alive()
        for h in self.view.hosts:
            if h != self.host and h not in alive:
                raise HostLostError(h, self.generation,
                                    lease_gap_s=self.lease_gap(h))

    def _resize_leader(self, survivors: List[str]) -> str:
        """Who writes the next generation: the lowest survivor that was
        IN the current generation (a waiting joiner — alive, compatible,
        but not yet a member — must not lead a world it has never been
        part of: it is busy inside join(), not resize(), and electing it
        would leave the record forever unwritten). Falls back to the
        lowest survivor when no current member survived."""
        current = set(self.view.hosts) if self.view is not None else set()
        incumbents = [h for h in survivors if h in current]
        return (incumbents or survivors)[0]

    def resize(self, max_attempts: int = 5,
               settle_s: Optional[float] = None,
               timeout_s: float = 60.0) -> WorldView:
        """Move to the next generation with every live, compatible
        member (losses shrink the world; a waiting joiner grows it).

        Convergent under churn: the new leader (lowest live member)
        creates gen g+1 with O_EXCL after a settle delay (one heartbeat,
        so a dying member's lease has a chance to lapse before the
        membership is frozen); everyone adopts the record and acks.
        If a *listed* member dies before acking, the ack barrier raises
        HostLostError and the loop tries g+2 — bounded by
        `max_attempts`."""
        settle = self.heartbeat_s if settle_s is None else settle_s
        for _ in range(max_attempts):
            g = self.generation + 1
            rec = self.read_generation(g)
            if rec is None:
                time.sleep(settle)
                survivors = sorted(self._compatible(self.alive()))
                if not survivors:
                    raise RendezvousError("no live members to resize with")
                if self._resize_leader(survivors) == self.host:
                    self._write_generation(g, survivors)
                rec = self.read_generation(g)
            if rec is None:
                # another host is the leader and has not written yet
                deadline = time.time() + timeout_s
                while rec is None and time.time() < deadline:
                    time.sleep(self.poll_s)
                    rec = self.read_generation(g)
                    if rec is None:
                        survivors = sorted(self._compatible(self.alive()))
                        if survivors and \
                                self._resize_leader(survivors) == self.host:
                            self._write_generation(g, survivors)
                if rec is None:
                    raise RendezvousTimeout(
                        f"generation {g} record never appeared "
                        f"within {timeout_s:.0f}s")
            view = self._adopt(rec)
            try:
                self._ack_generation(view, time.time() + timeout_s)
            except HostLostError:
                # a listed member died mid-resize: bump the generation
                # counter past the failed record and go again
                self.generation = int(rec["generation"])
                continue
            return view
        raise RendezvousError(
            f"membership would not settle after {max_attempts} resize "
            f"attempts (generation {self.generation})")

    # -- barriers + consensus ----------------------------------------------

    def _barrier_dir(self, name: str, scope: WorldView,
                     seq: bool = True) -> str:
        if not seq:
            return os.path.join(self.root, "barriers",
                                str(scope.generation), name)
        n = self._seq.get(name, 0)
        self._seq[name] = n + 1
        return os.path.join(self.root, "barriers",
                            str(scope.generation), f"{name}#{n}")

    def barrier(self, name: str, timeout_s: float = 60.0,
                payload: Optional[dict] = None,
                scope: Optional[WorldView] = None,
                seq: bool = True) -> Dict[str, dict]:
        """Deadline-bounded, lease-checked barrier over the generation's
        members. Returns every member's payload. Raises HostLostError
        the moment a straggler's lease expires (detection within the
        heartbeat deadline — the property a blocking collective
        barrier cannot have) and RendezvousTimeout if the deadline
        passes with everyone still alive (a logic bug — same-name
        barriers out of step — not a death)."""
        scope = scope or self.view
        if scope is None:
            raise RendezvousError("no world view: join() or attach() first")
        if scope.world_size == 1:
            return {self.host: dict(payload or {})}
        bdir = self._barrier_dir(name, scope, seq=seq)
        os.makedirs(bdir, exist_ok=True)
        _atomic_write(os.path.join(bdir, f"{self.host}.json"),
                      {"host": self.host, "ts": time.time(),
                       **(payload or {})})
        deadline = time.time() + timeout_s
        while True:
            ballots: Dict[str, dict] = {}
            for h in scope.hosts:
                rec = _read_json(os.path.join(bdir, f"{h}.json"))
                if rec is not None:
                    ballots[h] = rec
            if len(ballots) == len(scope.hosts):
                return ballots
            alive = self.alive()
            for h in scope.hosts:
                if h != self.host and h not in ballots and h not in alive:
                    # TOCTOU guard: a peer that acked AFTER our ballot
                    # sweep and then cleanly leave()d (the preflight
                    # probe's join-then-leave shape) has no lease but
                    # DID pass the barrier — re-read its ballot before
                    # declaring a corpse
                    if _read_json(os.path.join(bdir, f"{h}.json")) \
                            is not None:
                        continue  # re-sweep picks it up
                    raise HostLostError(h, scope.generation,
                                        detail=f"missed barrier {name!r}",
                                        lease_gap_s=self.lease_gap(h))
            if time.time() > deadline:
                missing = sorted(set(scope.hosts) - set(ballots))
                raise RendezvousTimeout(
                    f"barrier {name!r} deadline ({timeout_s:.0f}s) passed "
                    f"with live stragglers {missing} — barrier callsites "
                    "are out of step")
            time.sleep(self.poll_s)

    def agree(self, name: str, flag: bool, timeout_s: float = 60.0) -> bool:
        """Global OR of a per-host boolean — the preemption-consensus
        primitive, deadline-bounded. Same discipline as barrier()."""
        ballots = self.barrier(name, timeout_s=timeout_s,
                               payload={"flag": bool(flag)})
        return any(bool(b.get("flag")) for b in ballots.values())
