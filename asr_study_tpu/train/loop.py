"""The training loop: epochs over length-bucketed batches, periodic eval,
checkpointing, logging, optional profiling.

Replaces the reference's ``model.fit_generator(...)`` orchestration
[ref: train.py] with an explicit loop around the jitted ``Trainer`` steps.
Host work per step is only the numpy batch hand-off; everything else is one
device dispatch (SURVEY.md §3.1 hot-loop analysis).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import jax

from asr_study_tpu.data.prefetch import device_prefetch
from asr_study_tpu.train.checkpoint import CheckpointManager
from asr_study_tpu.train.trainer import Trainer, TrainState
from asr_study_tpu.utils.metrics_writer import MetricWriter


def fit(
    trainer: Trainer,
    state: TrainState,
    train_iter,                      # DatasetIterator
    valid_iter=None,
    epochs: int = 10,
    seed: int = 0,
    ckpt: Optional[CheckpointManager] = None,
    hparams: Optional[Dict[str, Any]] = None,
    log_dir: Optional[str] = None,
    log_every: int = 10,
    profile: bool = False,
    profile_steps: tuple = (10, 20),
    tensorboard: bool = False,
    early_stop_patience: int = 0,
    sortagrad: bool = False,
    monitor: str = "val_loss",
) -> TrainState:
    """Run ``epochs`` epochs; returns the final state.

    ``profile=True`` captures a jax.profiler trace (Perfetto/XProf-readable)
    of steps [profile_steps) into ``<log_dir>/trace`` — the tracing hook the
    reference never had (SURVEY.md §5.1).

    ``early_stop_patience`` > 0 stops training once ``monitor`` (val_loss
    or val_ler; lower is better) has not improved for that many
    consecutive epochs (the Keras ``EarlyStopping`` idiom; requires
    ``valid_iter``).  The same metric should drive the checkpoint
    manager's best retention (``CheckpointManager(best_metric=...)``) —
    the train CLI's ``--monitor`` sets both.

    ``sortagrad=True`` runs the FIRST epoch of training in ascending-
    duration batch order (SortaGrad, Deep Speech 2): early CTC steps see
    short, easy alignments, which stabilizes the warm-up phase.  Only the
    true first epoch — a resumed run (state.step > 0) never re-orders.
    """
    if early_stop_patience > 0 and valid_iter is None:
        raise ValueError(
            "early_stop_patience requires a validation split (val_loss "
            "drives the stopping decision) — none was provided"
        )
    import jax.numpy as jnp

    writer = MetricWriter(log_dir, "train", tensorboard=tensorboard)
    rng = jax.random.PRNGKey(seed)
    step = int(state.step)
    first_epoch_ordered = sortagrad and step == 0
    t_last = time.time()
    last_log_step = step
    trace_open = False
    best_val = float("inf")
    stale_epochs = 0

    # Epoch loss accumulates ON DEVICE (weighted by real rows, not
    # batch.size): each step adds two dispatched scalar ops and fetches
    # NOTHING — a per-step host fetch would stall dispatch behind the
    # device.  Host syncs happen once per log_every steps (one step LATE,
    # so the next dispatch overlaps them) + once per epoch.
    @jax.jit
    def _acc(acc, loss, w):
        w = w.astype(jnp.float32)
        return (acc[0] + loss * w, acc[1] + w)

    def consume_log(pending):
        """Pooled fetch of a LOG step's metrics (issued >=1 step late)."""
        nonlocal t_last, last_log_step
        p_step, p_metrics, p_epoch = pending
        loss = float(p_metrics["loss"])
        now = time.time()
        # actual steps since the last log row — NOT log_every: the
        # epoch-end flush covers a partial window (r5 review: assuming
        # log_every inflated those rows up to log_every/partial ×)
        n_steps = max(p_step - last_log_step, 1)
        writer.write(
            p_step,
            {
                "epoch": p_epoch,
                "loss": loss,
                "grad_norm": float(p_metrics["grad_norm"]),
                "steps_per_s": n_steps / max(now - t_last, 1e-9),
            },
            echo=True,
        )
        t_last = now
        last_log_step = p_step

    for epoch in range(epochs):
        ep_acc = (jnp.zeros(()), jnp.zeros(()))
        pending = None               # (step, device metrics, epoch)
        batches = device_prefetch(
            train_iter.epoch(
                seed=seed + epoch,
                ordered=first_epoch_ordered and epoch == 0,
            ),
            depth=2,
            sharding=trainer.batch_sharding,
        )
        for batch in batches:
            if profile and log_dir and step == profile_steps[0]:
                jax.profiler.start_trace(f"{log_dir}/trace")
                trace_open = True
            state, metrics = trainer.train_step(
                state, batch.inputs, batch.input_lengths, batch.labels,
                batch.label_lengths, batch.weights, rng,
            )
            step += 1
            if trace_open and step == profile_steps[1]:
                # wait for the profiled steps before stopping the trace
                jax.block_until_ready(metrics["loss"])
                jax.profiler.stop_trace()
                trace_open = False
            ep_acc = _acc(ep_acc, metrics["loss"], batch.weights.sum())
            if step % log_every == 0:
                if pending is not None:
                    consume_log(pending)
                pending = (step, metrics, epoch)
        if pending is not None:
            consume_log(pending)

        ep_loss, ep_w = (float(x) for x in ep_acc)
        scalars: Dict[str, float] = {
            "epoch": epoch, "train_loss": ep_loss / max(ep_w, 1e-9)
        }
        if valid_iter is not None:
            val = trainer.run_eval(state, valid_iter.epoch())
            scalars["val_loss"] = val["loss"]
            scalars["val_ler"] = val["ler"]
        writer.write(step, scalars, echo=True)
        if ckpt is not None:
            ckpt.save(
                state,
                metrics={k: v for k, v in scalars.items() if k != "epoch"},
                hparams=hparams,
            )
        if early_stop_patience > 0 and monitor in scalars:
            if scalars[monitor] < best_val - 1e-6:
                best_val = scalars[monitor]
                stale_epochs = 0
            else:
                stale_epochs += 1
                if stale_epochs >= early_stop_patience:
                    import sys

                    print(
                        f"early stop: {monitor} has not improved for "
                        f"{stale_epochs} epochs (best {best_val:.4g})",
                        file=sys.stderr,
                    )
                    break
    if trace_open:
        # training ended inside the profile window (short run, early
        # stop): finalize the trace rather than leaving it open/corrupt
        jax.profiler.stop_trace()
    writer.close()
    return state
