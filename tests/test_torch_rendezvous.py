"""The port's rendezvous (resilience/rendezvous.py) against the JAX
package's, on tests/test_rendezvous.py's scenarios before
TestHostSupervisor: join, attach, leave, lease gaps, admission and
version-skew refusal, barriers, agree, resize.

Each scenario runs once with each package's `Rendezvous`, in a
directory of its own, and returns what it saw: the WorldView dicts
(with the coordinator's port masked: a free port is drawn each time),
the error types and kinds raised, the records on disk. The two must be
equal. One more test puts a reference host and a port host into one
generation of one directory, which shows the records on disk are
interchangeable.
"""
import json
import os
import threading
import time

import pytest

from deep_vision_tpu.resilience import rendezvous as ref_rdzv
from deep_vision_tpu_torch.resilience import rendezvous as port_rdzv

FAST = dict(heartbeat_s=0.25, poll_s=0.01)
IMPLS = {"ref": ref_rdzv, "port": port_rdzv}


def view_dict(view):
    """WorldView.to_dict with the coordinator's port masked."""
    d = view.to_dict()
    host, _, port = (d["coordinator"] or "").rpartition(":")
    d["coordinator"] = f"{host}:<port>" if port.isdigit() else None
    return d


def join_world(mod, root, hosts, expect=None, timeout_s=20.0, **kw):
    """Join `hosts` concurrently (threads); -> ({host: (rdzv, view)},
    {host: error})."""
    expect = expect if expect is not None else len(hosts)
    out, errs = {}, {}

    def run(h):
        r = mod.Rendezvous(root, h, **FAST, **kw)
        try:
            out[h] = (r, r.join(expect_hosts=expect, timeout_s=timeout_s))
        except Exception as e:
            errs[h] = e

    ts = [threading.Thread(target=run, args=(h,)) for h in hosts]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout_s + 10)
    return out, errs


def views(out):
    return {h: view_dict(v) for h, (_, v) in sorted(out.items())}


def leave_all(out):
    for r, _ in out.values():
        r.leave()


def in_threads(fn, hosts):
    res = {}

    def run(h):
        res[h] = fn(h)

    ts = [threading.Thread(target=run, args=(h,)) for h in hosts]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return res


# -- the scenarios: mod is a rendezvous module, root a fresh directory --------

def three_hosts_form_generation_zero(mod, root):
    out, errs = join_world(mod, root, ["h0", "h1", "h2"])
    assert not errs
    got = views(out)
    assert [out[f"h{i}"][1].rank for i in range(3)] == [0, 1, 2]
    leave_all(out)
    return {"views": got,
            "gen0": sorted(json.load(open(os.path.join(root, "gen",
                                                       "0.json"))))}


def join_timeout_names_who_showed_up(mod, root):
    r = mod.Rendezvous(root, "only", **FAST)
    with pytest.raises(mod.RendezvousTimeout) as ei:
        r.join(expect_hosts=2, timeout_s=0.5)
    assert "only" in str(ei.value)
    return {"error": type(ei.value).__name__,
            "members": sorted(os.listdir(os.path.join(root, "members")))}


def version_skewed_joiner_refused_in_seconds(mod, root):
    incumbent = mod.Rendezvous(root, "good", **FAST,
                               client_version="torch 2.11")
    incumbent.start_heartbeat()
    skewed = mod.Rendezvous(root, "stale", **FAST,
                            client_version="torch 1.13")
    t0 = time.time()
    with pytest.raises(mod.RendezvousRefused) as ei:
        skewed.join(expect_hosts=2, timeout_s=30.0)
    assert time.time() - t0 < 5.0
    refusal = json.load(open(os.path.join(root, "refused", "stale.json")))
    incumbent.leave()
    return {"kind": ei.value.kind,
            "refusal": {k: refusal[k] for k in ("host", "kind", "detail",
                                                 "versions")},
            "refusal_keys": sorted(refusal)}


def skewed_host_joining_first_does_not_poison(mod, root):
    stale = mod.Rendezvous(root, "aa-stale-but-first", **FAST,
                           client_version="v0.3")
    stale.start_heartbeat()
    time.sleep(2 * FAST["heartbeat_s"])
    # both correct hosts' leases land before either votes (the race of
    # a record landing mid-vote is tiebreak_gets_grace_before_self_refusal's)
    rdzvs = {h: mod.Rendezvous(root, h, **FAST, client_version="v0.4")
             for h in ("m", "n")}
    for r in rdzvs.values():
        r.start_heartbeat()
    joined = in_threads(lambda h: rdzvs[h].join(expect_hosts=2,
                                                timeout_s=20.0), ("m", "n"))
    out = {h: (rdzvs[h], v) for h, v in joined.items()}
    got = views(out)
    refusal = json.load(open(os.path.join(root, "refused",
                                          "aa-stale-but-first.json")))
    leave_all(out)
    stale.leave()
    return {"views": got, "refusal_kind": refusal["kind"]}


def tiebreak_gets_grace_before_self_refusal(mod, root):
    m = mod.Rendezvous(root, "m", **FAST, client_version="v0.4")
    members = {
        "stale": {"host": "stale", "ts": time.time(), "joined_ts": 1.0,
                  "client_version": "v0.3"},
        "m": {"host": "m", "ts": time.time(), "joined_ts": 2.0,
              "client_version": "v0.4"},
    }
    m._check_admission(members)
    seen = [m._tie_since is not None]
    m._tie_since = time.time() - 10 * FAST["heartbeat_s"]
    with pytest.raises(mod.RendezvousRefused) as ei:
        m._check_admission(members)
    m2 = mod.Rendezvous(os.path.join(root, "b"), "m", **FAST,
                        client_version="v0.4")
    m2._check_admission(dict(members))
    seen.append(m2._tie_since is not None)
    members["n"] = {"host": "n", "ts": time.time(), "joined_ts": 3.0,
                    "client_version": "v0.4"}
    m2._check_admission(members)
    seen.append(m2._tie_since is None)
    return {"kind": ei.value.kind, "seen": seen}


def fresh_fleet_over_stale_records(mod, root):
    out, errs = join_world(mod, root, ["a", "b"])
    assert not errs
    coord0 = out["a"][1].coordinator
    for r, _ in out.values():
        r._hb_stop.set()  # the whole world dies; its records remain
    time.sleep(4 * FAST["heartbeat_s"])
    out2, errs2 = join_world(mod, root, ["a", "b"])
    assert not errs2, errs2
    assert all(v.coordinator != coord0 for _, v in out2.values())
    got = views(out2)
    leave_all(out2)
    return {"views": got}


def joiner_grows_a_running_world_at_resize(mod, root):
    out, errs = join_world(mod, root, ["b", "c"])
    assert not errs
    joined = {}

    def late_join():
        r = mod.Rendezvous(root, "a", **FAST)
        joined["a"] = (r, r.join(expect_hosts=3, timeout_s=20))

    tj = threading.Thread(target=late_join)
    tj.start()
    time.sleep(3 * FAST["heartbeat_s"])
    waiting = "a" not in joined
    res = in_threads(lambda h: out[h][0].resize(), ("b", "c"))
    tj.join(30)
    got = {h: view_dict(v) for h, v in sorted(res.items())}
    got["a"] = view_dict(joined["a"][1])
    ranks = {"a": joined["a"][1].rank, "b": res["b"].rank}
    for h in ("b", "c"):
        out[h][0].leave()
    joined["a"][0].leave()
    return {"waiting": waiting, "views": got, "ranks": ranks}


def attached_survivors_still_read_as_running(mod, root, monkeypatch):
    out, errs = join_world(mod, root, ["b", "c"])
    assert not errs
    monkeypatch.setenv(mod.ENV_GENERATION, "0")
    fresh = {}

    def reattach(h):
        r = mod.Rendezvous(root, h, **FAST)
        fresh[h] = r
        return view_dict(r.attach(timeout_s=10))

    attached = in_threads(reattach, ("b", "c"))
    monkeypatch.delenv(mod.ENV_GENERATION)
    joiner = mod.Rendezvous(root, "a", **FAST)
    with pytest.raises(mod.RendezvousTimeout):
        joiner.join(expect_hosts=3, timeout_s=1.0)
    squatted = joiner.read_generation(1) is not None
    leave_all(out)
    for r in fresh.values():
        r.leave()
    return {"attached": attached, "squatted": squatted}


def dead_fleets_stale_records_do_not_vote(mod, root):
    for i in range(3):
        old = mod.Rendezvous(root, f"dead{i}", **FAST,
                             client_version="OLD")
        old._joined_ts = time.time() - 100
        old.touch()
    time.sleep(4 * FAST["heartbeat_s"])
    out, errs = join_world(mod, root, ["x", "y"], expect=2,
                           client_version="NEW")
    assert not errs, errs
    got = views(out)
    leave_all(out)
    return {"views": got}


def refusal_marker_retires_after_the_fix(mod, root):
    incumbent = mod.Rendezvous(root, "good", **FAST, client_version="v2")
    incumbent.start_heartbeat()
    stale = mod.Rendezvous(root, "flaky", **FAST, client_version="v1")
    with pytest.raises(mod.RendezvousRefused):
        stale.join(expect_hosts=2, timeout_s=10)
    # the refused process is gone before its relaunch. The reference's
    # refused object would beat on (the port's has left already): see
    # test_a_refused_host_drops_its_lease
    stale.leave()
    fixed, inc = rejoin_beside_the_incumbent(mod, root, incumbent, 20)
    incumbent.leave()
    fixed["r"].leave()
    for who, got in (("flaky", fixed), ("good", inc)):
        assert "view" in got, f"{who}'s join: {got.get('error')!r}"
    return {"hosts": sorted(fixed["view"].hosts),
            "incumbent": sorted(inc["view"].hosts)}


def rejoin_beside_the_incumbent(mod, root, incumbent, timeout_s):
    """"flaky" at v2 and the incumbent join at once, on two threads;
    -> ({"view" or "error", "r": the new Rendezvous}, {"view" or
    "error"}): a join that raised (a timeout, a refusal) says so."""
    fixed, inc = {}, {}

    def join(out, r):
        try:
            out["view"] = r.join(expect_hosts=2, timeout_s=timeout_s)
        except Exception as e:
            out["error"] = e

    fixed["r"] = mod.Rendezvous(root, "flaky", **FAST, client_version="v2")
    ts = [threading.Thread(target=join, args=(fixed, fixed["r"])),
          threading.Thread(target=join, args=(inc, incumbent))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout_s + 10)
    return fixed, inc


def leader_excludes_skewed_member(mod, root):
    r = mod.Rendezvous(root, "a", **FAST, client_version="v1")
    members = {
        "a": {"host": "a", "ts": time.time(), "joined_ts": 1.0,
              "client_version": "v1"},
        "b": {"host": "b", "ts": time.time(), "joined_ts": 2.0,
              "client_version": "v1"},
        "z": {"host": "z", "ts": time.time(), "joined_ts": 3.0,
              "client_version": "v2-skewed"},
    }
    compat = sorted(r._compatible(members))
    refusal = json.load(open(os.path.join(root, "refused", "z.json")))
    return {"compat": compat, "kind": refusal["kind"],
            "versions": refusal["versions"]}


def agree_is_global_or_and_reusable(mod, root):
    out, errs = join_world(mod, root, ["a", "b"])
    assert not errs
    got = []
    for flags in ((True, False), (False, False)):
        got.append(in_threads(
            lambda h, f=dict(zip(("a", "b"), flags)): out[h][0].agree(
                "stop", f[h], timeout_s=10), ("a", "b")))
    barrier_dirs = sorted(os.listdir(os.path.join(root, "barriers", "0")))
    leave_all(out)
    return {"agree": got, "barrier_dirs": barrier_dirs}


def dead_peer_yields_host_lost_not_hang(mod, root):
    out, errs = join_world(mod, root, ["a", "b"])
    assert not errs
    ra, rb = out["a"][0], out["b"][0]
    rb._hb_stop.set()
    t0 = time.time()
    with pytest.raises(mod.HostLostError) as ei:
        ra.barrier("after-death", timeout_s=30.0)
    assert time.time() - t0 < 5.0
    ra.leave()
    return {"host": ei.value.host, "generation": ei.value.generation,
            "gap": ei.value.lease_gap_s is not None}


def live_stragglers_hit_the_deadline(mod, root):
    out, errs = join_world(mod, root, ["a", "b"])
    assert not errs
    with pytest.raises(mod.RendezvousTimeout) as ei:
        out["a"][0].barrier("nobody-else-comes", timeout_s=0.5)
    leave_all(out)
    return {"error": type(ei.value).__name__,
            "message": str(ei.value)}


def check_names_the_corpse_with_lease_gap(mod, root):
    out, errs = join_world(mod, root, ["a", "b"])
    assert not errs
    ra, rb = out["a"][0], out["b"][0]
    ra.check()
    gap_alive = ra.lease_gap("b")
    rb._hb_stop.set()
    time.sleep(4 * FAST["heartbeat_s"])
    with pytest.raises(mod.HostLostError) as ei:
        ra.check()
    assert ei.value.lease_gap_s > ra.lease_s >= gap_alive
    ra.leave()
    return {"host": ei.value.host, "alive": sorted(ra.alive()),
            "lease_s": ra.lease_s}


def leave_drops_the_member_record(mod, root):
    out, errs = join_world(mod, root, ["a", "b"])
    assert not errs
    before = sorted(out["a"][0].members())
    record = sorted(out["a"][0].members()["b"])
    out["b"][0].leave()
    after = sorted(out["a"][0].members())
    gap = out["a"][0].lease_gap("b")
    out["a"][0].leave()
    return {"before": before, "after": after, "gap_after": gap,
            "record_keys": record}


def three_to_two_re_ranks_densely(mod, root):
    out, errs = join_world(mod, root, ["h0", "h1", "h2"])
    assert not errs
    out["h1"][0]._hb_stop.set()
    time.sleep(4 * FAST["heartbeat_s"])
    res = in_threads(lambda h: out[h][0].resize(), ("h0", "h2"))
    assert res["h0"].coordinator == res["h2"].coordinator
    got = {h: view_dict(v) for h, v in sorted(res.items())}
    ranks = {h: v.rank for h, v in res.items()}
    for h in ("h0", "h2"):
        out[h][0].leave()
    return {"views": got, "ranks": ranks}


def attach_reenters_a_written_generation(mod, root, monkeypatch):
    out, errs = join_world(mod, root, ["a", "b"])
    assert not errs
    monkeypatch.setenv(mod.ENV_GENERATION, "0")
    fresh = {}

    def run(h):
        r = mod.Rendezvous(root, h, **FAST)
        fresh[h] = r
        return r.attach(timeout_s=10)

    res = in_threads(run, ("a", "b"))
    got = {h: view_dict(v) for h, v in sorted(res.items())}
    leave_all(out)
    for r in fresh.values():
        r.leave()
    return {"views": got, "ranks": {h: v.rank for h, v in res.items()}}


def attach_without_a_record_raises(mod, root):
    r = mod.Rendezvous(root, "a", **FAST)
    with pytest.raises(mod.RendezvousError) as ei:
        r.attach(generation=3, timeout_s=1.0)
    r.leave()
    return {"error": type(ei.value).__name__}


SCENARIOS = {f.__name__: f for f in (
    three_hosts_form_generation_zero, join_timeout_names_who_showed_up,
    version_skewed_joiner_refused_in_seconds,
    skewed_host_joining_first_does_not_poison,
    tiebreak_gets_grace_before_self_refusal,
    fresh_fleet_over_stale_records, joiner_grows_a_running_world_at_resize,
    attached_survivors_still_read_as_running,
    dead_fleets_stale_records_do_not_vote,
    refusal_marker_retires_after_the_fix, leader_excludes_skewed_member,
    agree_is_global_or_and_reusable, dead_peer_yields_host_lost_not_hang,
    live_stragglers_hit_the_deadline,
    check_names_the_corpse_with_lease_gap, leave_drops_the_member_record,
    three_to_two_re_ranks_densely, attach_reenters_a_written_generation,
    attach_without_a_record_raises)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_the_reference(name, tmp_path, monkeypatch):
    fn = SCENARIOS[name]
    got = {}
    for impl, mod in IMPLS.items():
        root = str(tmp_path / impl)
        os.makedirs(root)
        kw = {"monkeypatch": monkeypatch} \
            if "monkeypatch" in fn.__code__.co_varnames else {}
        got[impl] = fn(mod, root, **kw)
    assert got["port"] == got["ref"]


def test_world_view_and_versions_are_the_references():
    for mod in IMPLS.values():
        v = mod.WorldView(generation=2, hosts=("a", "b", "c"), host="b")
        assert (v.rank, v.world_size, v.shard()) == (1, 3, (1, 3))
    for mine, theirs in [({"client_version": "x"}, {"client_version": "x"}),
                         ({"client_version": "x"}, {"client_version": "y"}),
                         ({}, {"client_version": "x"}),
                         ({"platform_version": "a"},
                          {"platform_version": "b"})]:
        assert port_rdzv.versions_compatible(mine, theirs) == \
            ref_rdzv.versions_compatible(mine, theirs)
    assert port_rdzv.WorldView(1, ("a",), "a").to_dict() == \
        ref_rdzv.WorldView(1, ("a",), "a").to_dict()
    assert (port_rdzv.ENV_GENERATION, port_rdzv.REFUSAL_VERSION_SKEW,
            port_rdzv.REFUSAL_EVICTED) == (
        ref_rdzv.ENV_GENERATION, ref_rdzv.REFUSAL_VERSION_SKEW,
        ref_rdzv.REFUSAL_EVICTED)


def test_a_reference_host_and_a_port_host_share_one_generation(tmp_path):
    """Mixed membership: one directory, one host of each package. They
    form one generation, pass barriers and agree across packages, each
    sees the other's lease, a port host re-attaches to the generation
    record the mix wrote, and the records on disk carry the same keys."""
    root = str(tmp_path)
    rdzvs = {"r": ref_rdzv.Rendezvous(root, "r", **FAST),
             "t": port_rdzv.Rendezvous(root, "t", **FAST)}
    got = in_threads(lambda h: rdzvs[h].join(expect_hosts=2, timeout_s=20),
                     ("r", "t"))
    assert view_dict(got["r"]) == dict(view_dict(got["t"]), host="r")
    assert got["r"].hosts == ("r", "t") and got["t"].rank == 1
    flags = in_threads(lambda h: rdzvs[h].agree("stop", h == "t",
                                               timeout_s=10), ("r", "t"))
    assert flags == {"r": True, "t": True}
    in_threads(lambda h: rdzvs[h].barrier("sync", timeout_s=10), ("r", "t"))
    assert sorted(rdzvs["r"].alive()) == sorted(rdzvs["t"].alive()) == \
        ["r", "t"]
    records = {h: json.load(open(os.path.join(root, "members", f"{h}.json")))
               for h in ("r", "t")}
    assert sorted(records["r"]) == sorted(records["t"])
    again = port_rdzv.Rendezvous(root, "t", **FAST)
    assert view_dict(again.attach(generation=0, timeout_s=10)) == \
        view_dict(got["t"])
    # the port host dies (its heartbeats stop): the reference host's
    # barrier names it within the lease deadline
    again._hb_stop.set()
    rdzvs["t"]._hb_stop.set()
    with pytest.raises(ref_rdzv.HostLostError) as ei:
        rdzvs["r"].barrier("after-death", timeout_s=30.0)
    assert ei.value.host == "t"
    for r in (rdzvs["r"], rdzvs["t"], again):
        r.leave()


def test_a_slow_reader_does_not_age_a_live_lease(tmp_path, monkeypatch):
    """The port reads the clock before the record; the reference reads
    it after sweeping every member record, so when each read waits (a
    fleet parent's GIL held by JSON work in other threads) a live
    member's lease reads as older than it is."""
    gaps = {}
    for impl, mod in IMPLS.items():
        root = str(tmp_path / impl)
        live = mod.Rendezvous(root, "a", heartbeat_s=1.0)
        live.touch()
        other = mod.Rendezvous(root, "b", heartbeat_s=1.0)
        other.touch()
        reader = mod.Rendezvous(root, "parent", heartbeat_s=1.0)
        read = mod._read_json

        def slow(path, _read=read):
            time.sleep(0.4)
            return _read(path)

        monkeypatch.setattr(mod, "_read_json", slow)
        gaps[impl] = reader.lease_gap("a")
        monkeypatch.setattr(mod, "_read_json", read)
    assert gaps["port"] < 0.3
    assert gaps["ref"] > 0.7  # two records read, each after a 0.4 s wait


def test_a_refused_host_drops_its_lease(tmp_path, monkeypatch):
    """A host refused by its standing marker raises; the reference's
    Rendezvous keeps beating its old member record then, the port's
    leaves. The refusal scenario with the refused object left running
    and each rejoining host's first member sweep held until that object
    has rewritten flaky's v1 record (the interleaving a loaded host
    makes by chance, as in a loaded test run): with both records 1-vs-1, the
    v1 record is the earliest joiner and so the version reference, the
    incumbent refuses itself and flaky's ack barrier times out. The port
    forms the world."""
    got = {}
    for impl, mod in IMPLS.items():
        root = str(tmp_path / impl)
        sweep = mod.Rendezvous.members
        held = set()

        def members(self, _sweep=sweep, _held=held):
            if self.versions.get("client_version") == "v2" \
                    and self.host not in _held:
                _held.add(self.host)
                path = os.path.join(self.root, "members", "flaky.json")
                deadline = time.time() + 4 * FAST["heartbeat_s"]
                while time.time() < deadline:
                    rec = mod._read_json(path) or {}
                    if rec.get("client_version") == "v1":
                        break
                    time.sleep(0.002)
            return _sweep(self)

        incumbent = mod.Rendezvous(root, "good", **FAST,
                                   client_version="v2")
        incumbent.start_heartbeat()
        stale = mod.Rendezvous(root, "flaky", **FAST, client_version="v1")
        with pytest.raises(mod.RendezvousRefused):
            stale.join(expect_hosts=2, timeout_s=10)
        beating = stale._hb_thread is not None \
            and stale._hb_thread.is_alive()
        monkeypatch.setattr(mod.Rendezvous, "members", members)
        fixed, inc = rejoin_beside_the_incumbent(mod, root, incumbent, 3.0)
        monkeypatch.setattr(mod.Rendezvous, "members", sweep)
        for r in (incumbent, fixed["r"], stale):
            r.leave()
        got[impl] = {
            "beating": beating,
            "flaky": sorted(fixed["view"].hosts) if "view" in fixed
            else type(fixed["error"]).__name__,
            "good": sorted(inc["view"].hosts) if "view" in inc
            else getattr(inc["error"], "kind", type(inc["error"]).__name__)}
    assert got["port"] == {"beating": False, "flaky": ["flaky", "good"],
                           "good": ["flaky", "good"]}
    assert got["ref"] == {"beating": True, "flaky": "RendezvousTimeout",
                          "good": ref_rdzv.REFUSAL_VERSION_SKEW}
