"""Poll the live telemetry plane: one status line per process (the
port of the repo-level tools/obs_poll.py).

    python -m deep_vision_tpu_torch.tools.obs_poll --run-dir CKPT_DIR
    python -m deep_vision_tpu_torch.tools.obs_poll --run-dir D --watch 2

Each process that serves telemetry (train_cli --telemetry-port, a
Server's or a ReplicaPool's TelemetryServer with a discovery_dir) drops
a `telemetry-<role>-<pid>.json` discovery file under its run dir; this
tool reads those files (obs/telemetry.py read_discovery), hits each
process's /statusz, /healthz and /alertz, and renders one line per
process:

    train        pid 4242 @ 127.0.0.1:35411   OK         step 8  ep 1  \
        1650.3 ex/s  p50 158.5ms/p95 199.5ms  recompiles 0
    serve        pid 4260 @ 127.0.0.1:35600   UNHEALTHY(serve:r1)

A process whose endpoint no longer answers renders as GONE: a stale
discovery file from a process that died.

`--once` (the default) prints one snapshot and exits 0 if every
discovered process is healthy, 1 otherwise (the reference's docstring
names `--once`, but its parser lacks the flag; here it is one).
`--watch SECONDS` loops forever. A line carries a `gp NN%` goodput column where a process
serves a goodput status, which none does until the goodput plane is
ported, and an `ALERTS rule,rule` column from /alertz while a rule
fires; `--strict-alerts` turns a firing alert into a non-zero exit (and
stops a --watch loop at the first firing snapshot).
"""
from __future__ import annotations

import argparse
import json
import time
import urllib.error
import urllib.request


def fetch_json(host: str, port: int, path: str, timeout: float = 3.0):
    """GET http://host:port/path, parsed JSON — None on any failure."""
    url = f"http://{host}:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except (OSError, urllib.error.URLError, ValueError):
        return None


def _healthz(host: str, port: int, timeout: float = 3.0):
    """(ok, body) from /healthz — a 503 still carries the JSON verdict."""
    url = f"http://{host}:{port}/healthz"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return True, json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        try:
            return False, json.loads(e.read().decode("utf-8"))
        except (OSError, ValueError):
            return False, None
    except (OSError, urllib.error.URLError, ValueError):
        return None, None


def _unhealthy_names(body) -> str:
    if not isinstance(body, dict):
        return ""
    bad = [name for name, chk in (body.get("checks") or {}).items()
           if not chk.get("ok", False)]
    return ",".join(sorted(bad))


def format_line(rec: dict, status: dict, ok, health, alertz=None) -> str:
    """One line: role pid@host:port verdict + role-specific vitals."""
    role = str(rec.get("role", "?"))
    where = f"pid {rec.get('pid', '?')} @ {rec['host']}:{rec['port']}"
    if ok is None:
        return f"{role:<13}{where:<28} GONE"
    verdict = "OK" if ok else f"UNHEALTHY({_unhealthy_names(health)})"
    vitals = []
    for name, src in (status or {}).get("status", {}).items():
        if not isinstance(src, dict):
            continue
        if src.get("step") is not None:
            vitals.append(f"step {src['step']}")
        if src.get("epoch") is not None:
            vitals.append(f"ep {src['epoch']}")
        if src.get("examples_per_sec") is not None:
            vitals.append(f"{src['examples_per_sec']:.1f} ex/s")
        if src.get("generation") is not None:
            vitals.append(f"gen {src['generation']}")
        if src.get("served") is not None:
            vitals.append(f"served {src['served']}")
        if src.get("done") is not None:
            vitals.append(f"done {src['done']}")
        # perf status source (obs/perfwatch.py): rolling step-time
        # tail, last gate verdict, and the recompile count — the live
        # "is this process performance-healthy" vitals
        if src.get("step_time_ms_p50") is not None:
            line = f"p50 {src['step_time_ms_p50']:.1f}ms"
            if src.get("step_time_ms_p95") is not None:
                line += f"/p95 {src['step_time_ms_p95']:.1f}ms"
            vitals.append(line)
        gate = src.get("gate")
        if isinstance(gate, dict) and gate.get("verdict"):
            vitals.append(f"gate {gate['verdict']}")
        if src.get("recompiles") is not None:
            vitals.append(f"recompiles {src['recompiles']}")
        # goodput status source (obs/goodput.py): what fraction of this
        # process's wall clock went to productive work
        if src.get("goodput_frac") is not None:
            vitals.append(f"gp {float(src['goodput_frac']) * 100:.0f}%")
    # the /alertz column: which burn-rate rules are firing RIGHT NOW —
    # an empty active list renders nothing, keeping clean lines clean
    active = _active_alerts(alertz)
    if active:
        vitals.append("ALERTS " + ",".join(active))
    return f"{role:<13}{where:<28} {verdict:<10} " + "  ".join(vitals)


def _active_alerts(alertz) -> list:
    """Sorted active rule names out of a /alertz body; [] when none."""
    if not isinstance(alertz, dict):
        return []
    return sorted(str(a.get("rule", "?")) for a in
                  (alertz.get("active") or []) if isinstance(a, dict))


def poll_once(run_dir: str, timeout: float = 3.0):
    """(lines, all_ok, any_alert) for every discovery file under run_dir."""
    from deep_vision_tpu_torch.obs.telemetry import read_discovery

    lines, all_ok, any_alert = [], True, False
    recs = read_discovery(run_dir)
    if not recs:
        return [f"no telemetry discovery files under {run_dir}"], False, False
    for rec in recs:
        host, port = rec["host"], rec["port"]
        ok, health = _healthz(host, port, timeout=timeout)
        status = fetch_json(host, port, "/statusz", timeout=timeout)
        alertz = fetch_json(host, port, "/alertz", timeout=timeout) \
            if ok is not None else None
        lines.append(format_line(rec, status, ok, health, alertz))
        if ok is not True:
            all_ok = False
        if _active_alerts(alertz):
            any_alert = True
    return lines, all_ok, any_alert


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run-dir", required=True,
                   help="directory holding telemetry-*.json discovery files "
                        "(the run's checkpoint dir)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--once", action="store_true",
                      help="one snapshot, then exit (the default)")
    mode.add_argument("--watch", type=float, default=None,
                      metavar="SECONDS",
                      help="refresh every SECONDS instead of one snapshot")
    p.add_argument("--timeout", type=float, default=3.0,
                   help="per-endpoint HTTP timeout")
    p.add_argument("--strict-alerts", action="store_true",
                   help="exit non-zero while any burn-rate alert is "
                        "firing (/alertz active list non-empty); with "
                        "--watch the loop exits at the first firing "
                        "snapshot instead of running forever")
    args = p.parse_args(argv)

    while True:
        lines, all_ok, any_alert = poll_once(args.run_dir,
                                             timeout=args.timeout)
        for line in lines:
            print(line)
        if args.strict_alerts and any_alert:
            return 1
        if args.watch is None:
            return 0 if all_ok else 1
        print("--", flush=True)
        time.sleep(args.watch)


if __name__ == "__main__":
    raise SystemExit(main())
