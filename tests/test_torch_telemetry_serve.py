"""The live telemetry plane on the port's serving fleet
(serve/router.py and serve/pool.py `telemetry=`) against the JAX
package's, each over its toy predictor (tests/test_serve_pool.py's and
tests/test_torch_serve_pool.py's).

After the reference's TestServeRespawn: a pool with a TelemetryServer
registers `fleet` and `serve:<rid>` (the reference's names); the fault
spec `serve.replica:io_error@1` kills a replica, the respawned Server
takes its predecessor's slot by name, /healthz answers 200 and /statusz
shows every replica `serving`, in both packages. A Server's source
answers 503 once it drains. A canary's `serve:canary1` leaves with the
canary in the port; the reference keeps the drained canary's entry, so
its /healthz stays 503 after the swap (ROADMAP, reference faults the
port does not repeat).
"""
import json
import os
import sys
import time
import urllib.error
import urllib.request

import pytest

from deep_vision_tpu.obs import RunJournal as RefJournal
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu.obs.telemetry import TelemetryServer as RefTelemetry
from deep_vision_tpu.resilience import faults as ref_faults
from deep_vision_tpu.serve import ReplicaPool as RefPool
from deep_vision_tpu.serve import ServeError as RefServeError
from deep_vision_tpu.serve import Server as RefServer
from deep_vision_tpu_torch.obs import TelemetryServer
from deep_vision_tpu_torch.obs.journal import RunJournal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.resilience import faults
from deep_vision_tpu_torch.serve import ReplicaPool, ServeError, Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests.test_serve_pool import (  # noqa: E402
    build_engine_factory as ref_factory,
)
from tests.test_serve_pool import images  # noqa: E402
from tests.test_torch_serve_pool import (  # noqa: E402
    build_engine_factory as port_factory,
)

PACKAGES = {
    "ref": (RefTelemetry, RefRegistry, RefJournal, RefPool, RefServer,
            ref_faults, RefServeError, ref_factory),
    "port": (TelemetryServer, Registry, RunJournal, ReplicaPool, Server,
             faults, ServeError, port_factory),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.install(None)
    ref_faults.install(None)


def get(address, path):
    try:
        with urllib.request.urlopen(f"http://{address}{path}",
                                    timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_all_serving(pool, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(s == "serving" for s in pool.replica_states().values()):
            return True
        time.sleep(0.02)
    return False


def fleet(name, tmp_path):
    """(telemetry, pool, journal) of package `name`, started."""
    tele_cls, reg_cls, journal_cls, pool_cls, *_, factory = PACKAGES[name]
    reg = reg_cls()
    j = journal_cls(str(tmp_path / f"{name}.jsonl"), kind="serve")
    tele = tele_cls(port=0, role="serve", registry=reg, journal=j,
                    discovery_dir=str(tmp_path / name)).start()
    pool = pool_cls(factory(reg, journal=j) if name == "ref"
                    else factory(reg), replicas=2, journal=j, registry=reg,
                    max_wait_ms=3.0, telemetry=tele)
    return tele, pool.start(), j


def shut(tele, pool, j):
    pool.drain("close")
    tele.close()
    if not j._closed:
        j.close()


def test_the_endpoint_survives_a_replica_respawn(tmp_path):
    seen = {}
    for name in PACKAGES:
        _, _, _, _, _, fmod, serve_error, _ = PACKAGES[name]
        tele, pool, j = fleet(name, tmp_path)
        try:
            code, body = get(tele.address, "/healthz")
            before = (code, sorted(body["checks"]))
            fmod.install_spec("serve.replica:io_error@1", seed=0,
                              journal=j, export_env=False)
            futs = [pool.submit("toy", im) for im in images(6)]
            errors = 0
            for f in futs:
                try:
                    f.result(timeout=30)
                except serve_error:
                    errors += 1
            fmod.install(None)
            assert wait_all_serving(pool), name
            code, health = get(tele.address, "/healthz")
            _, status = get(tele.address, "/statusz")
            seen[name] = (before, errors, code, sorted(health["checks"]),
                          {rid: r["state"] for rid, r in
                           status["status"]["fleet"]["replicas"].items()},
                          sorted(status["status"]))
        finally:
            fmod.install(None)
            shut(tele, pool, j)
    assert seen["port"] == seen["ref"]
    before, errors, code, checks, states, sections = seen["port"]
    assert before == (200, ["fleet", "serve:r0", "serve:r1"])
    assert errors >= 1 and code == 200
    assert checks == ["fleet", "serve:r0", "serve:r1"]
    assert states == {"r0": "serving", "r1": "serving"}
    assert sections == ["fleet", "serve:r0", "serve:r1"]


@pytest.mark.parametrize("tags", [None, {"replica": "edge"}])
def test_a_drained_servers_source_turns_unhealthy(tmp_path, tags):
    out = {}
    for name in PACKAGES:
        tele_cls, reg_cls, _, _, server_cls, _, _, factory = PACKAGES[name]
        reg = reg_cls()
        engine = factory(reg)("r0")
        engine.warmup()
        tele = tele_cls(port=0).start()
        try:
            server = server_cls(engine, registry=reg, tags=tags,
                                telemetry=tele)
            unstarted = get(tele.address, "/healthz")
            server.start()
            serving = get(tele.address, "/healthz")
            server.drain("close")
            drained = get(tele.address, "/healthz")
            _, status = get(tele.address, "/statusz")
        finally:
            tele.close()
        out[name] = (unstarted, serving, drained, status["status"])
    assert out["port"][:3] == out["ref"][:3]
    unstarted, serving, drained, status = out["port"]
    source = f"serve:{(tags or {}).get('replica', 'server')}"
    assert [unstarted[0], serving[0], drained[0]] == [503, 200, 503]
    assert drained[1]["checks"][source]["draining"] is True
    assert sorted(status) == sorted(out["ref"][3]) == [source]
    assert status[source]["draining"] is True


def test_a_removed_canary_leaves_the_port_healthy(tmp_path):
    """The reference keeps the drained canary's `serve:canary1`, so its
    /healthz answers 503 after the canary is gone; the port removes it."""
    got = {}
    for name in PACKAGES:
        *_, factory = PACKAGES[name]
        tele, pool, j = fleet(name, tmp_path)
        try:
            canary = factory(Registry() if name == "port"
                             else RefRegistry())("canary")
            canary.warmup()
            rid = pool.add_canary(canary, 50)
            mounted = get(tele.address, "/healthz")
            pool.remove_canary()
            removed = get(tele.address, "/healthz")
        finally:
            shut(tele, pool, j)
        got[name] = (rid, mounted[0], sorted(mounted[1]["checks"]),
                     removed[0], sorted(removed[1]["checks"]))
    assert got["port"][:3] == got["ref"][:3] == (
        "canary1", 200, ["fleet", "serve:canary1", "serve:r0", "serve:r1"])
    assert got["ref"][3:] == (503, ["fleet", "serve:canary1", "serve:r0",
                                    "serve:r1"])
    assert got["port"][3:] == (200, ["fleet", "serve:r0", "serve:r1"])
