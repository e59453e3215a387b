"""Self-describing checkpoints: weights + training metadata, resumable.

Equivalent of the reference's ``MetaCheckpoint`` Keras callback
[ref: core/callbacks.py], which wrote weights plus a meta payload (epoch,
hparams, loss history) into one HDF5 so runs are resumable.  Here the
payload ``{params, opt_state}`` is one ``.npz`` per step, keyed by tree
path and written atomically (temp file + rename), plus a JSON sidecar with
hparams/history; ``latest`` and ``best`` retention both supported, like
the reference's two MetaCheckpoint instances.  Saves are synchronous.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

import jax
import numpy as np

from asr_study_tpu.train.trainer import TrainState


def _flatten(tree) -> Dict[str, Any]:
    """{tree-path string: leaf} in tree order."""
    return {
        jax.tree_util.keystr(path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _host(x) -> np.ndarray:
    a = np.asarray(x)
    # .npz has no bfloat16: store the exact float32 upcast; restores cast
    # back to the target's dtype
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def _write_json(path: str, obj) -> None:
    _atomic_write(path, lambda f: f.write(json.dumps(obj, indent=1).encode()))


class CheckpointManager:
    """Keeps ``latest`` and (optionally) ``best`` checkpoints under a dir.

    Like the reference's two MetaCheckpoint instances, 'latest' and 'best'
    live in SEPARATE retention domains — a single best-managed store
    would delete newer-but-worse checkpoints and silently break
    resume-from-latest.

    Layout::

        <dir>/ckpt/<step>.npz   latest checkpoints (recency retention)
        <dir>/best/<step>.npz   best-by-metric checkpoint
        <dir>/best/best.json    {step, metric, value} of that checkpoint
        <dir>/meta.json         {hparams, history, last_step}
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 2,
        keep_best: bool = True,
        best_metric: str = "val_loss",
        mode: str = "min",
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        self._latest_dir = os.path.join(self.directory, "ckpt")
        self._best_dir = os.path.join(self.directory, "best")
        os.makedirs(self._latest_dir, exist_ok=True)
        if keep_best:
            os.makedirs(self._best_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.mode = mode
        self.keep_best = keep_best
        self._meta_path = os.path.join(self.directory, "meta.json")
        self.meta: Dict[str, Any] = {"history": [], "hparams": {}}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)

    # -- save -------------------------------------------------------------
    @staticmethod
    def _steps(directory: str):
        return sorted(
            int(os.path.basename(p)[:-4])
            for p in glob.glob(os.path.join(directory, "*.npz"))
        )

    def _best_record(self) -> Optional[dict]:
        path = os.path.join(self._best_dir, "best.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save(
        self,
        state: TrainState,
        metrics: Optional[Dict[str, float]] = None,
        hparams: Optional[Dict[str, Any]] = None,
    ) -> None:
        step = int(state.step)
        arrays = {
            k: _host(v) for k, v in _flatten(
                {"params": state.params, "opt_state": state.opt_state}
            ).items()
        }

        def write(path):
            _atomic_write(path, lambda f: np.savez(f, **arrays))

        write(os.path.join(self._latest_dir, f"{step}.npz"))
        for old in self._steps(self._latest_dir)[: -self.max_to_keep]:
            os.remove(os.path.join(self._latest_dir, f"{old}.npz"))
        m = {k: float(v) for k, v in (metrics or {}).items()}
        if self.keep_best and self.best_metric in m:
            value = m[self.best_metric]
            prev = self._best_record()
            better = prev is None or (
                value < prev["value"] if self.mode == "min"
                else value > prev["value"]
            )
            if better:
                write(os.path.join(self._best_dir, f"{step}.npz"))
                _write_json(os.path.join(self._best_dir, "best.json"), {
                    "step": step, "metric": self.best_metric,
                    "value": value,
                })
                for old in self._steps(self._best_dir):
                    if old != step:
                        os.remove(os.path.join(self._best_dir, f"{old}.npz"))
        if hparams is not None:
            self.meta["hparams"] = dict(hparams)
        if metrics:
            self.meta["history"].append({"step": step, **metrics})
        self.meta["last_step"] = step
        _write_json(self._meta_path, self.meta)

    # -- restore ----------------------------------------------------------
    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps(self._latest_dir)
        return steps[-1] if steps else None

    @property
    def best_step(self) -> Optional[int]:
        rec = self._best_record() if self.keep_best else None
        return None if rec is None else int(rec["step"])

    def _resolve(self, step: Optional[int], best: bool) -> str:
        """Path of the checkpoint to restore; loud when there is none."""
        if step is not None:
            return os.path.join(self._latest_dir, f"{step}.npz")
        if best:
            step = self.best_step
            if step is None:
                # an empty best store (run trained without val metrics)
                # must not silently hand back the LATEST weights
                raise FileNotFoundError(
                    f"no BEST checkpoint under {self.directory} (was "
                    "the run trained without a validation metric?)"
                )
            return os.path.join(self._best_dir, f"{step}.npz")
        step = self.latest_step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}"
            )
        return os.path.join(self._latest_dir, f"{step}.npz")

    def restore(
        self, state: TrainState, step: Optional[int] = None,
        best: bool = False,
    ) -> TrainState:
        """Restore into the structure of ``state``: every leaf takes the
        target's dtype and placement, so a run saved on one device set
        resumes on another."""
        path = self._resolve(step, best)
        target = {"params": state.params, "opt_state": state.opt_state}
        flat = _flatten(target)
        with np.load(path) as z:
            missing = sorted(set(flat) - set(z.files))
            if missing:
                raise ValueError(
                    f"checkpoint {path} lacks {missing[:3]} — different "
                    "model or optimizer?"
                )
            # mirror the target's placement: committed leaves (a mesh
            # layout) keep their sharding; uncommitted ones stay
            # uncommitted, so the restored state lowers to the same
            # program as a fresh one and hits the compile cache
            leaves = [
                jax.device_put(np.asarray(z[k], np.dtype(v.dtype)),
                               v.sharding if v.committed else None)
                for k, v in flat.items()
            ]
        restored = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(target), leaves
        )
        step = int(os.path.basename(path)[:-4])
        return TrainState(
            params=restored["params"],
            opt_state=restored["opt_state"],
            step=jax.numpy.asarray(step, dtype=jax.numpy.int32),
        )

    def restore_params(self, params, step: Optional[int] = None,
                       best: bool = False):
        """Warm-start restore: ONLY the model params, into the structure
        of ``params`` — the checkpoint's optimizer state is ignored, so a
        run trained with one optimizer can seed a run using another
        (``train.py --init_from``) and eval never rebuilds the optimizer.
        Leaves land on the current default device.  Shapes and tree paths
        must match exactly."""
        path = self._resolve(step, best)
        want = _flatten({"params": params})
        with np.load(path) as z:
            got = [k for k in z.files if k.startswith("['params']")]
            if len(got) != len(want):
                raise ValueError(
                    f"checkpoint under {self.directory} has {len(got)} "
                    f"param arrays, model expects {len(want)} — "
                    "different architecture?"
                )
            out = []
            for gp, (wp, w) in zip(got, want.items()):
                # key paths must match too: same-count same-shape trees
                # with different keys would otherwise silently load
                # weights into the wrong parameters
                if gp != wp:
                    raise ValueError(
                        f"param tree mismatch restoring from "
                        f"{self.directory}: checkpoint has {gp!r} where "
                        f"the model expects {wp!r} — different "
                        "architecture?"
                    )
                a = z[gp]
                if tuple(a.shape) != tuple(w.shape):
                    raise ValueError(
                        f"param shape mismatch restoring {wp!r} from "
                        f"{self.directory}: checkpoint {tuple(a.shape)} vs "
                        f"model {tuple(w.shape)}"
                    )
                out.append(jax.numpy.asarray(a, w.dtype))
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params), out
        )
