"""Checkpoint/resume, the port of deep_vision_tpu/core/checkpoint.py:61-468.

The format is the port's own. One step directory `<dir>/<step>/` holds
`state.pt`, a `torch.save` of the model's `state_dict` (parameters and
BatchNorm running statistics), the optimizer's `state_dict` (momentum,
moments, each group's current lr), the step counter and the state's
generator. It is written under a temporary name, fsynced and renamed,
so a step directory on disk is always whole. Beside it, the host
sidecar `host_state_<step>.json` (loggers, plateau, the DataLoader's
position) is written byte for byte as the reference writes it:
`{"__sidecar_format__": 1, "crc32c": <crc of the sorted-keys payload>,
"payload": ...}` through tmp + fsync + rename, after the array file. The
crc32c is the native record library's (data/native.py `crc32c`), so no
google_crc32c is needed; the reference's `_read_sidecar` reads the
port's sidecars and the port reads the reference's.

Saving is asynchronous, as orbax's is: `save` copies every tensor to
pinned host memory on the current (the step's) stream, so the next step,
queued after the copies on that stream, cannot overwrite what is being
saved; one writer thread then waits for the copies, writes the step
directory and the sidecar, and prunes to `max_to_keep`. `wait()` joins
that thread (and re-raises its error); a second `save` waits for the
first. `last_save` holds the save's `block_ms` (the caller's time in
`save`) and `write_ms` (from the call until the sidecar landed), also
journaled as a `note` ("checkpoint_written") when the write lands.

Storage is treated as unreliable, as in the reference: sidecar writes
retry transient I/O through resilience/retry.py's RetryPolicy, and
`restore()` walks a fallback chain. A step whose arrays fail to load,
whose sidecar is corrupt, or whose sidecar is missing while sibling
steps have one (the process died between the array rename and the
sidecar's) is quarantined into `<dir>/quarantine/` with a typed
`ckpt_quarantine` journal event, and the newest valid step restores
instead. An explicitly requested step that fails validation raises
CheckpointCorruptError. The `ckpt.save`, `ckpt.restore` and
`ckpt.sidecar` fault points (resilience/faults.py) make every path
testable on the CPU.

Cross-mesh restore (the reference's `mesh=`, re-placing arrays saved on
N devices onto M) has no counterpart on one device: the port restores
onto the devices the caller's model and optimizer live on, and `mesh`
must be None.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device
from deep_vision_tpu_torch.data.native import crc32c
from deep_vision_tpu_torch.resilience import faults
from deep_vision_tpu_torch.resilience.retry import RetryPolicy

_SIDECAR_RE = re.compile(r"host_state_(\d+)\.json$")
_SIDECAR_FORMAT = 1
#: the reference's sidecar key for sharding metadata; dropped on read
SHARDING_META_KEY = "__sharding__"
STATE_FILE = "state.pt"


def state_arrays(state) -> dict:
    """The serializable part of a TrainState: the model's and the
    optimizer's state_dicts, the step and the generator's state."""
    return {"step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state()}


def _check_state(state, loaded: dict) -> None:
    """Raise unless `loaded` (a state_arrays dict) has the model's keys
    and shapes."""
    model_sd = state.model.state_dict()
    got = loaded["model"]
    if set(got) != set(model_sd):
        raise KeyError(
            f"model state mismatch: missing "
            f"{sorted(set(model_sd) - set(got))[:5]}, unexpected "
            f"{sorted(set(got) - set(model_sd))[:5]}")
    for k, v in got.items():
        if v.shape != model_sd[k].shape:
            raise ValueError(f"{k}: saved shape {tuple(v.shape)}, "
                             f"model {tuple(model_sd[k].shape)}")


def _load_state(state, loaded: dict) -> None:
    """Load a checked state_arrays dict into a TrainState, in place."""
    state.model.load_state_dict(loaded["model"])
    state.optimizer.load_state_dict(loaded["optimizer"])
    state.step = int(loaded["step"])
    if loaded.get("generator") is not None:
        state.generator.set_state(loaded["generator"])


def _to_host(obj, pinned: List[torch.Tensor]):
    """A copy of `obj` with every tensor copied to host memory: CUDA
    tensors into pinned buffers, asynchronously on the current stream
    (collected in `pinned`), CPU tensors cloned."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cuda":
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            pinned.append(out)
            return out
        return t.clone()
    if isinstance(obj, dict):
        return {k: _to_host(v, pinned) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, pinned) for v in obj)
    return obj


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested step failed validation (corrupt sidecar
    or unloadable arrays). The latest-step path never raises this: it
    quarantines and falls back instead."""


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 best_mode: Optional[str] = None,
                 best_metric: Optional[str] = None, journal=None,
                 retry: Optional[RetryPolicy] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_mode = best_mode
        self._best_metric = best_metric
        self._best_value = None
        self.journal = journal
        self._retry = retry or RetryPolicy(
            name="ckpt.sidecar", max_attempts=4, base_delay_s=0.05,
            max_delay_s=2.0)
        # array loads retry transient I/O before the fallback chain may
        # judge a step corrupt
        self._restore_retry = RetryPolicy(
            name="ckpt.restore", max_attempts=3, base_delay_s=0.2,
            max_delay_s=5.0)
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._last_saved: Optional[int] = None
        self.last_save: Optional[dict] = None

    # -- host-side sidecar -------------------------------------------------
    def _sidecar_path(self, step: int) -> str:
        return os.path.join(self.directory, f"host_state_{step}.json")

    def _sidecar_steps(self) -> List[int]:
        return [int(m.group(1)) for m in map(_SIDECAR_RE.match,
                                             os.listdir(self.directory))
                if m]

    def _write_sidecar(self, step: int, host_state: dict) -> None:
        """Atomic, checksummed, retried sidecar write."""
        self._retry.call(self._write_sidecar_once, step, host_state)

    def _write_sidecar_once(self, step: int, host_state: dict) -> None:
        faults.fire("ckpt.sidecar")
        payload = json.dumps(host_state, sort_keys=True)
        doc = json.dumps({
            "__sidecar_format__": _SIDECAR_FORMAT,
            "crc32c": int(crc32c(payload.encode())),
            "payload": host_state,
        }, sort_keys=True)
        # the corrupt fault flips bytes after checksumming: rot the
        # checksum must catch
        data = faults.transform("ckpt.sidecar", doc.encode())
        path = self._sidecar_path(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            faults.fire("ckpt.sidecar", stage="after_write")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def _read_sidecar(self, step: int) -> Tuple[Optional[dict],
                                                Optional[str]]:
        """(host_state, error). (None, None): no sidecar on disk;
        (None, reason): a sidecar exists but failed validation."""
        path = self._sidecar_path(step)
        if not os.path.exists(path):
            return None, None
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            return None, f"sidecar unreadable: {type(e).__name__}: {e}"
        if not isinstance(doc, dict):
            return None, "sidecar is not a JSON object"
        if "__sidecar_format__" not in doc:
            return doc, None  # pre-checksum legacy sidecar: accept as-is
        payload = doc.get("payload")
        want = doc.get("crc32c")
        got = int(crc32c(json.dumps(payload, sort_keys=True).encode()))
        if want != got:
            return None, f"sidecar checksum mismatch (want {want}, got {got})"
        return payload, None

    # -- step directories --------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """The committed steps on disk, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def _write_step(self, step: int, tree: dict) -> int:
        """tree -> `<dir>/<step>/state.pt` through a fsynced temporary
        directory and a rename; returns the file's bytes."""
        final = self._step_dir(step)
        tmp = f"{final}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, STATE_FILE)
        with open(path, "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):  # a re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        return os.path.getsize(os.path.join(final, STATE_FILE))

    def _gc(self) -> None:
        """Keep the newest max_to_keep steps; drop the rest with their
        sidecars (a leftover sidecar would make a pruned step look like
        an incomplete save)."""
        steps = self.all_steps()
        if self.max_to_keep is not None and len(steps) > self.max_to_keep:
            for s in steps[:len(steps) - self.max_to_keep]:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        keep = set(self.all_steps())
        if not keep:
            return
        for s in self._sidecar_steps():
            if s not in keep:
                try:
                    os.remove(self._sidecar_path(s))
                except OSError:
                    pass

    # -- quarantine + fallback restore -------------------------------------
    def _quarantine(self, step: int, reason: str) -> None:
        """Move a failed step (directory and sidecar) under quarantine/
        for a post-mortem, so no later restore sees it."""
        qdir = os.path.join(self.directory, "quarantine")

        def unique(dst: str) -> str:
            out, n = dst, 1
            while os.path.exists(out):
                out = f"{dst}.{n}"
                n += 1
            return out

        moved = []
        os.makedirs(qdir, exist_ok=True)
        for src in (self._step_dir(step), self._sidecar_path(step)):
            if os.path.exists(src):
                dst = unique(os.path.join(qdir, os.path.basename(src)))
                try:
                    os.replace(src, dst)
                    moved.append(dst)
                except OSError as e:
                    reason += f"; quarantine move failed: {e}"
        print(f"checkpoint: QUARANTINED step {step} ({reason}); "
              f"falling back to the newest valid step", file=sys.stderr)
        from deep_vision_tpu_torch.obs.registry import get_registry

        get_registry().counter("ckpt_quarantine_total",
                               "checkpoint steps quarantined").inc()
        if self.journal is not None:
            self.journal.write("ckpt_quarantine", step=int(step),
                               reason=reason, moved_to=moved)

    def _load(self, step: int) -> dict:
        path = os.path.join(self._step_dir(step), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def _restore_with_fallback(
            self, apply: Callable[[dict], Any], step: Optional[int]
    ) -> Tuple[Optional[int], Any, Optional[dict]]:
        """(restored_step, value, host_state); (None, None, None) when
        no valid checkpoint remains. Explicit `step`: validate or raise;
        `step=None`: the newest valid, quarantining the rest on the way.
        `apply(loaded)` must check the loaded tree whole before it
        changes anything."""
        self.wait()

        def attempt(s: int):
            def once():
                faults.fire("ckpt.restore")
                return self._load(s)

            return apply(self._restore_retry.call(once))

        if step is not None:
            if step not in set(self.all_steps()):
                raise FileNotFoundError(
                    f"no checkpoint step {step} in {self.directory!r}")
            host_state, err = self._read_sidecar(step)
            if err is not None:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} in {self.directory!r}: {err}")
            try:
                value = attempt(step)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} in {self.directory!r}: array "
                    f"restore failed: {type(e).__name__}: {e}") from e
            return step, value, self._drop_meta(host_state)
        sidecar_steps = set(self._sidecar_steps())
        for s in reversed(self.all_steps()):
            host_state, err = self._read_sidecar(s)
            if err is None and host_state is None and sidecar_steps - {s}:
                # arrays committed, no sidecar, while siblings have one:
                # the process died between the two renames
                err = ("sidecar missing while other steps have one "
                       "(save died before the sidecar landed)")
            if err is None:
                try:
                    return s, attempt(s), self._drop_meta(host_state)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    err = f"array restore failed: {type(e).__name__}: {e}"
            self._quarantine(s, err)
            sidecar_steps.discard(s)
        return None, None, None

    @staticmethod
    def _drop_meta(host_state):
        if isinstance(host_state, dict):
            host_state.pop(SHARDING_META_KEY, None)
        return host_state

    # -- save/restore API --------------------------------------------------
    def _start_write(self, step: int, tree: dict,
                     host_state: Optional[dict]) -> None:
        """Copy `tree` to host memory on the current stream, then hand
        the copies to the writer thread."""
        t0 = time.perf_counter()
        self.wait()
        pinned: List[torch.Tensor] = []
        host_tree = _to_host(tree, pinned)
        event = None
        if pinned:
            event = torch.cuda.Event()
            event.record()
        doc = dict(host_state) if host_state else {}
        block_ms = (time.perf_counter() - t0) * 1e3

        def write():
            try:
                if event is not None:
                    event.synchronize()
                nbytes = self._write_step(step, host_tree)
                self._write_sidecar(step, doc)
                self._gc()
                self.last_save = {
                    "step": step, "bytes": nbytes, "block_ms": block_ms,
                    "write_ms": (time.perf_counter() - t0) * 1e3}
                if self.journal is not None:
                    self.journal.write("note", note="checkpoint_written",
                                       **self.last_save)
            except BaseException as e:  # re-raised by wait()
                self._writer_error = e

        self._last_saved = step
        self._writer = threading.Thread(target=write, name="ckpt-writer",
                                        daemon=True)
        self._writer.start()

    def save(self, step: int, state, host_state: Optional[dict] = None,
             metrics=None) -> bool:
        """Save a TrainState (asynchronously) and its JSON host state.
        Returns True if a save was started; False when `best_mode`
        finds the metric no better, or the step is already saved."""
        if self._best_mode and metrics is not None and \
                self._best_metric in metrics:
            v = float(metrics[self._best_metric])
            better = (self._best_value is None
                      or (self._best_mode == "min" and v < self._best_value)
                      or (self._best_mode == "max" and v > self._best_value))
            if not better:
                return False
            self._best_value = v
        if step == self._last_saved:
            return False
        faults.fire("ckpt.save")
        self._start_write(step, state_arrays(state), host_state)
        return True

    def restore(self, state, step: Optional[int] = None, mesh=None):
        """Restore into `state` (its model, optimizer, step and
        generator, in place); returns (state, host_state). With
        `step=None` the fallback chain runs; when nothing valid remains,
        the state is returned untouched with host_state None."""
        if mesh is not None:
            raise NotImplementedError(
                "cross-mesh restore is not ported: one device has no mesh")

        def apply(loaded: dict):
            _check_state(state, loaded)
            _load_state(state, loaded)
            return state

        found, restored, host_state = self._restore_with_fallback(apply,
                                                                  step)
        if found is None:
            return state, None
        self._last_saved = found
        return restored, host_state

    def save_states(self, step: int, states: dict,
                    host_state: Optional[dict] = None) -> bool:
        """Save several TrainStates as one step (a GAN's sub-networks):
        `{name: state_arrays(state)}`, asynchronously, with the JSON host
        state. Returns False when the step is already saved."""
        if step == self._last_saved:
            return False
        faults.fire("ckpt.save")
        self._start_write(step, {k: state_arrays(v) for k, v in
                                 states.items()}, host_state)
        return True

    def restore_states(self, states: dict, step: Optional[int] = None):
        """Restore a `save_states` step into `states` ({name:
        TrainState}, in place, each checked before any is changed);
        returns (states, host_state), or (None, None) when nothing valid
        is saved. The fallback chain is `restore`'s."""
        def apply(loaded: dict):
            if set(loaded) != set(states):
                raise KeyError(f"saved states {sorted(loaded)}, want "
                               f"{sorted(states)}")
            for k, state in states.items():
                _check_state(state, loaded[k])
            for k, state in states.items():
                _load_state(state, loaded[k])
            return states

        found, restored, host_state = self._restore_with_fallback(apply,
                                                                  step)
        if found is None:
            return None, None
        self._last_saved = found
        return restored, host_state

    def save_tree(self, step: int, tree: dict,
                  host_state: Optional[dict] = None) -> bool:
        """Save a dict of tensors (the EMA shadow; an int8 tree's leaves
        as nested dicts) with its host state."""
        if step == self._last_saved:
            return False
        faults.fire("ckpt.save")
        self._start_write(step, dict(tree), host_state)
        return True

    def restore_tree(self, template: dict, step: Optional[int] = None,
                     mesh=None):
        """Restore a dict saved by `save_tree` onto `template`'s keys,
        shapes, dtypes and devices (nested dicts, such as an int8 leaf's
        q8 and scale, level by level); returns (tree, host_state), or
        (None, None) when nothing valid is saved."""
        if mesh is not None:
            raise NotImplementedError(
                "cross-mesh restore is not ported: one device has no mesh")

        def apply(loaded: dict, like: dict = template):
            if not isinstance(loaded, dict) or set(loaded) != set(like):
                saved = sorted(loaded)[:5] if isinstance(loaded, dict) \
                    else type(loaded).__name__
                raise KeyError(f"tree keys differ: saved {saved}"
                               f", template {sorted(like)[:5]}")
            out = {}
            for k, t in like.items():
                v = loaded[k]
                if isinstance(t, dict):
                    out[k] = apply(v, t)
                    continue
                if v.shape != t.shape or v.dtype != t.dtype:
                    raise ValueError(f"{k}: saved {v.dtype}{tuple(v.shape)},"
                                     f" template {t.dtype}{tuple(t.shape)}")
                out[k] = v.to(t.device)
            return out

        found, restored, host_state = self._restore_with_fallback(apply,
                                                                  step)
        if found is None:
            return None, None
        return restored, host_state

    def restore_variables(self, step: Optional[int] = None,
                          device: DeviceLike = None) -> dict:
        """Template-free restore of the model's state_dict (parameters
        and running statistics) on `device` (default cuda), for
        inference and export."""
        dev = resolve_device(device)
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory!r}")
        faults.fire("ckpt.restore")
        return {k: v.to(dev) for k, v in self._load(step)["model"].items()}

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Join the writer thread; re-raise what it raised."""
        t, self._writer = self._writer, None
        if t is not None:
            t.join()
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def close(self) -> None:
        self.wait()
