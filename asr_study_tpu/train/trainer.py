"""Jitted train/eval steps + data-parallel sharding over a device mesh.

JAX redesign of the reference's Keras orchestration [ref: train.py,
core/ctc_utils.py]: instead of ``model.compile(loss=ctc_dummy_loss)`` +
``fit_generator`` feeding numpy through a TF session, the whole step —
forward, CTC loss, backward, clip, optimizer update — is ONE jitted
function.  Data parallelism is ``jax.shard_map`` over a 1-D ``data`` mesh:
params replicated, batch split per device, gradients/metrics reduced with
``psum`` over the device interconnect (SURVEY.md §2.3/§7, BASELINE config
5).  shard_map (not jit-with-shardings) is deliberate: every device runs
the per-shard program on LOCAL shapes, so a custom kernel would see plain
dense arrays instead of needing an SPMD partitioning rule — no NCCL/MPI-
style code anywhere; XLA's collectives do the work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from asr_study_tpu.ops import ctc, metrics as metrics_ops


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    """Replicated training state (a pytree; jit-transparent)."""

    params: Any
    opt_state: Any
    step: jax.Array  # scalar int32


def make_optimizer(
    name: str = "adam",
    lr: float = 1e-3,
    clipnorm: float = 400.0,
    weight_decay: float = 0.0,
    lr_decay: float = 0.0,
    decay_steps: int = 0,
    accum_steps: int = 1,
    plateau_factor: float = 0.0,
    plateau_patience: int = 0,
    plateau_window: int = 1,
) -> optax.GradientTransformation:
    """Optimizer factory mirroring the reference's compile-time choices
    (Adam + clipnorm was the reference default [ref: train.py]).

    ``lr_decay`` in (0, 1) with ``decay_steps`` > 0 applies staircase
    exponential decay: lr *= lr_decay every ``decay_steps`` optimizer
    steps (pass the data layer's steps_per_epoch for per-epoch decay, the
    Keras-era LR-schedule idiom).  The schedule is indexed by the
    optimizer's step count, so ``--resume`` continues it correctly.

    ``accum_steps`` > 1 enables gradient accumulation (optax.MultiSteps):
    the mean gradient of k consecutive micro-batches feeds ONE optimizer
    apply — an effective batch of k x batch_size at the HBM footprint of
    one micro-batch (long-utterance / wide-model training on a fixed
    chip).  clipnorm and lr_decay act on the accumulated step, matching a
    genuine big-batch run; with equal-size fully-weighted micro-batches
    the parameter trajectory matches the big-batch one to float
    tolerance (weighted-mean losses compose exactly).

    ``plateau_factor`` in (0, 1) with ``plateau_patience`` > 0 is the
    Keras ``ReduceLROnPlateau`` idiom (optax.contrib.reduce_on_plateau):
    the per-step training loss is averaged over ``plateau_window``
    optimizer applies (pass steps_per_epoch for epoch granularity); when
    the averaged loss has not improved for ``plateau_patience`` windows,
    updates are scaled by ``plateau_factor``.  The scale lives in the
    optimizer state, so ``--resume`` keeps it.  The trainer feeds the
    loss via ``update(..., value=loss)``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if plateau_factor and not 0.0 < plateau_factor < 1.0:
        raise ValueError(
            f"plateau_factor must be in (0, 1), got {plateau_factor}"
        )
    if plateau_factor and plateau_patience <= 0:
        raise ValueError(
            f"plateau_factor={plateau_factor} needs plateau_patience > 0 "
            f"(got {plateau_patience})"
        )
    if lr_decay:
        if not 0.0 < lr_decay < 1.0:
            raise ValueError(f"lr_decay must be in (0, 1), got {lr_decay}")
        if decay_steps <= 0:
            raise ValueError(
                f"lr_decay={lr_decay} needs decay_steps > 0 "
                f"(got {decay_steps}) — silently ignoring the decay "
                "would train at constant lr"
            )
        lr = optax.exponential_decay(
            lr, transition_steps=decay_steps, decay_rate=lr_decay,
            staircase=True,
        )
    opts = {
        "adam": lambda: optax.adam(lr),
        "adamw": lambda: optax.adamw(lr, weight_decay=weight_decay),
        "sgd": lambda: optax.sgd(lr, momentum=0.9),
        "rmsprop": lambda: optax.rmsprop(lr),
    }
    if name not in opts:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(opts)}")
    chain = []
    if clipnorm and clipnorm > 0:
        chain.append(optax.clip_by_global_norm(clipnorm))
    chain.append(opts[name]())
    if plateau_factor:
        chain.append(optax.contrib.reduce_on_plateau(
            factor=plateau_factor, patience=plateau_patience,
            accumulation_size=max(1, plateau_window),
        ))
    tx = optax.chain(*chain)
    if accum_steps > 1:
        ms = optax.MultiSteps(tx, every_k_schedule=accum_steps)
        tx = optax.GradientTransformationExtraArgs(ms.init, ms.update)
    return tx


def make_mesh(num_devices: Optional[int] = None,
              model_devices: int = 1) -> Mesh:
    """``data`` mesh over the available devices; ``model_devices`` > 1
    adds a second ``model`` axis for tensor-parallel recurrences
    (parallel/tp.py) — total devices = data x model."""
    devs = jax.devices()
    n = num_devices or len(devs) // model_devices
    if model_devices > 1:
        return jax.make_mesh(
            (n, model_devices), ("data", "model"),
            devices=devs[: n * model_devices],
        )
    return jax.make_mesh((n,), ("data",), devices=devs[:n])


class Trainer:
    """Owns the jitted step functions for one (model, optimizer) pair.

    With a mesh, inputs are sharded over ``data`` and state is replicated;
    the same code runs single-chip when ``mesh=None``.
    """

    def __init__(
        self,
        model,
        optimizer: optax.GradientTransformation,
        mesh: Optional[Mesh] = None,
        donate_state: bool = True,
        compute_dtype: Optional[Any] = None,
        augment: Optional[Any] = None,
        featurizer: Optional[Any] = None,
        wav_augment: Optional[Any] = None,
    ):
        """``compute_dtype=jnp.bfloat16`` runs the network forward/backward
        in bf16 (tensor cores) with f32 master weights, f32 CTC loss, and f32
        optimizer state — classic mixed precision.  None = full f32.

        ``augment`` is an optional jittable ``(rng, inputs, input_lengths)
        -> inputs`` callable (e.g. ``features.augment.SpecAugment``) applied
        to the feature batch inside the train step only — on device, under
        jit/shard_map, never at eval.

        ``featurizer`` (a DeviceFeaturizer) switches the
        step inputs from features to RAW padded waveforms [B, N(, 1)] with
        sample-count ``input_lengths``: the whole wav->features->model->
        loss->backward step is then ONE XLA program — train directly from
        a ``make_dataset --input_parser raw`` dataset, no feature
        precompute, feature hyperparameters swappable per run.  The
        reference cannot do this: its host DSP is the expensive stage,
        while here features are matmul work inside the step
        [ref: preprocessing/audio.py precompute flow].
        SpecAugment composes (it applies to the featurized batch).

        ``wav_augment`` is the raw-domain analog (e.g.
        ``features.augment.WavAugment``: gain + additive noise), applied
        to the waveform batch before the in-step featurizer, train only —
        it therefore requires ``featurizer``."""
        if wav_augment is not None and featurizer is None:
            raise ValueError(
                "wav_augment operates on raw waveforms and needs "
                "featurizer= (the inputs are features otherwise)"
            )
        self.model = model
        self.augment = augment
        self.featurizer = featurizer
        self.wav_augment = wav_augment
        # normalize to the extra-args protocol: plain transforms ignore the
        # ``value=loss`` the train step always passes (reduce_on_plateau
        # consumes it)
        self.tx = optax.with_extra_args_support(optimizer)
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        # 2-D (data, model) mesh => gate-dim tensor-parallel recurrence
        self.tp_shards = (
            int(dict(zip(mesh.axis_names, mesh.devices.shape)).get(
                "model", 1
            )) if mesh is not None else 1
        )
        if mesh is not None:
            self._repl = NamedSharding(mesh, P())
            self._batched = NamedSharding(mesh, P("data"))
            # per-device programs on local shapes; psum over 'data' inside
            batched = P("data")
            repl = P()
            # check_vma=False: the RNN scan seeds its carry with replicated
            # zeros, which the varying-axes type check rejects; semantics
            # are unaffected (all cross-device reductions are explicit
            # psums in _train_step/_eval_step).
            train_fn = jax.shard_map(
                self._train_step,
                mesh=mesh,
                in_specs=(repl, batched, batched, batched, batched,
                          batched, repl),
                out_specs=(repl, repl),
                check_vma=False,
            )
            eval_fn = jax.shard_map(
                self._eval_step,
                mesh=mesh,
                in_specs=(repl, batched, batched, batched, batched,
                          batched),
                out_specs=repl,
                check_vma=False,
            )
        else:
            self._repl = self._batched = None
            train_fn = self._train_step
            eval_fn = self._eval_step
        self.train_step = jax.jit(
            train_fn, donate_argnums=(0,) if donate_state else ()
        )
        self.eval_step = jax.jit(eval_fn)

    def _psum(self, x):
        """Sum over the data axis (identity single-device)."""
        if self.mesh is None:
            return x
        return jax.lax.psum(x, "data")

    def _tp(self):
        """("model", shards) when the mesh has a model axis, else None.
        Gradients stay model-replicated (tp_slice's VJP psums the weight
        cotangents over "model"), so _psum over "data" alone is exact."""
        return ("model", self.tp_shards) if self.tp_shards > 1 else None

    @property
    def batch_sharding(self):
        """Sharding for device-bound batch fields (None single-chip)."""
        return self._batched

    # -- state ------------------------------------------------------------
    def init_state(self, key, input_dim: int) -> TrainState:
        params = self.model.init(key, input_dim)
        state = TrainState(
            params=params,
            opt_state=self.tx.init(params),
            step=jnp.zeros((), jnp.int32),
        )
        if self.mesh is not None:
            state = jax.device_put(state, self._repl)
        return state

    # -- steps ------------------------------------------------------------
    def _train_step(
        self, state: TrainState, inputs, input_lengths, labels,
        label_lengths, weights, rng,
    ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        rng = jax.random.fold_in(rng, state.step)
        if self.mesh is not None:
            # decorrelate per-device dropout masks
            rng = jax.random.fold_in(rng, jax.lax.axis_index("data"))
        if self.wav_augment is not None:
            # distinct stream from dropout/SpecAugment; drawn only when
            # enabled, so the no-augment rng schedule is untouched
            w = inputs[..., 0] if inputs.ndim == 3 else inputs
            w = self.wav_augment(
                jax.random.fold_in(rng, 0x3A), w, input_lengths
            )
            inputs = w[..., None] if inputs.ndim == 3 else w
        inputs, input_lengths = self._featurize(inputs, input_lengths)
        if self.augment is not None:
            # distinct stream from the dropout rng so masks decorrelate;
            # the no-augment rng schedule is untouched (trajectory parity)
            inputs = self.augment(
                jax.random.fold_in(rng, 0x5A), inputs, input_lengths
            )

        def loss_fn(params):
            p, x = params, inputs
            if self.compute_dtype is not None:
                cast = lambda a: (  # noqa: E731
                    a.astype(self.compute_dtype)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a
                )
                p = jax.tree_util.tree_map(cast, p)
                x = cast(x)
            logits = self.model.apply(
                p, x, input_lengths, train=True, rng=rng, tp=self._tp()
            )
            per_seq = ctc.ctc_loss(
                logits.astype(jnp.float32), input_lengths, labels,
                label_lengths, blank_id=self.model.blank_id,
            )
            # Per-shard weighted SUM: the global weighted mean (and its
            # gradient) is recovered after the cross-device psum, so DP
            # training is bit-comparable to a single big-batch step.
            return jnp.sum(per_seq * weights.astype(jnp.float32)), logits

        (loss_sum, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        loss_sum = self._psum(loss_sum)
        w_sum = self._psum(jnp.sum(weights.astype(jnp.float32)))
        grads = jax.tree_util.tree_map(lambda g: self._psum(g), grads)
        denom = jnp.maximum(w_sum, 1.0)
        grads = jax.tree_util.tree_map(lambda g: g / denom, grads)
        loss = loss_sum / denom
        gnorm = optax.global_norm(grads)
        updates, opt_state = self.tx.update(
            grads, state.opt_state, state.params, value=loss
        )
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params, opt_state, state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    def _featurize(self, inputs, input_lengths):
        """Raw padded wavs -> features when a featurizer is attached
        (identity otherwise).  Runs per-shard under shard_map; the
        featurizer's operator tables ride as replicated closure
        constants."""
        if self.featurizer is None:
            return inputs, input_lengths
        wavs = inputs[..., 0] if inputs.ndim == 3 else inputs
        return self.featurizer._transform(wavs, input_lengths)

    def _eval_step(
        self, state: TrainState, inputs, input_lengths, labels,
        label_lengths, weights,
    ) -> Dict[str, jax.Array]:
        inputs, input_lengths = self._featurize(inputs, input_lengths)
        logits = self.model.apply(
            state.params, inputs, input_lengths, train=False,
            tp=self._tp(),
        )
        per_seq = ctc.ctc_loss(
            logits, input_lengths, labels, label_lengths,
            blank_id=self.model.blank_id,
        )
        decoded, dec_lens = ctc.greedy_decode(
            logits, input_lengths, blank_id=self.model.blank_id
        )
        dist = metrics_ops.edit_distance(
            decoded, dec_lens, labels, label_lengths
        ).astype(jnp.float32)
        w = weights.astype(jnp.float32)
        loss_sum = self._psum(jnp.sum(per_seq * w))
        edit = self._psum(jnp.sum(dist * w))
        chars = self._psum(jnp.sum(label_lengths.astype(jnp.float32) * w))
        num = self._psum(jnp.sum(w))
        return {
            "loss": loss_sum / jnp.maximum(num, 1.0),
            "edit_dist": edit,
            "label_chars": jnp.maximum(chars, 1.0),
            "num_seqs": num,
        }

    # -- host-side convenience -------------------------------------------
    def run_eval(self, state: TrainState, batches) -> Dict[str, float]:
        """Aggregate greedy-decode LER + loss over an iterator of Batch.

        Accumulates ON DEVICE and fetches once at the end: per-batch
        ``float()`` fetches would stall dispatch behind the device."""
        acc = None
        for b in batches:
            out = self.eval_step(
                state, b.inputs, b.input_lengths, b.labels,
                b.label_lengths, b.weights,
            )
            vals = jnp.stack([
                out["edit_dist"].astype(jnp.float32),
                out["label_chars"].astype(jnp.float32),
                out["loss"].astype(jnp.float32)
                * out["num_seqs"].astype(jnp.float32),
                out["num_seqs"].astype(jnp.float32),
            ])
            acc = vals if acc is None else acc + vals
        if acc is None:
            return {"loss": 0.0, "ler": 0.0, "num_seqs": 0.0}
        import numpy as np

        tot_dist, tot_chars, tot_loss, n = np.asarray(acc)  # ONE fetch
        return {
            "loss": float(tot_loss) / max(float(n), 1.0),
            "ler": float(tot_dist) / max(float(tot_chars), 1.0),
            "num_seqs": float(n),
        }
