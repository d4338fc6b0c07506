"""Trainable soft-SDF model + distributed training step.

No reference analogue (the reference is inference-only CLI); this is the
framework's differentiable "model family": a small set of learnable
scalars controls the thresholding front-end, and gradients flow through the soft EDT back to both the parameters and the input pixels.

Parameters (all scalar, broadcast over pixels):
  threshold_bias — learnable shift of the 127.5 threshold midpoint
  log_tau        — learnable threshold temperature
  channel_mix    — logits mixing gray/alpha channels into the tested value
                   (generalizes the reference's -l channel switch into a
                   differentiable choice)

The training step shards over a ('data', 'y') mesh: batch over 'data'
(across hosts), image rows over 'y' (halo exchange). XLA inserts the
gradient all-reduce over 'data' from the mean-loss contraction and overlaps
it with the backward pass (latency-hiding scheduler).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from chaq_sdfgen.config import SoftConfig
from chaq_sdfgen.ops import softsdf
from chaq_sdfgen.parallel.sharded import sharded_soft_sdf_field

Params = Dict[str, jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class SoftSDFModel:
    """Differentiable SDF generator with learnable threshold front-end.

    ``init(key, example)`` returns the parameter dict; ``apply(params,
    img2ch float32 (..., H, W, 2))`` returns the signed soft SDF
    (..., H, W)."""

    spread: int = 16
    soft: SoftConfig = SoftConfig()
    mesh: Optional[Mesh] = None          # if set, use the sharded pipeline
    batch_axis: Optional[str] = None

    def init(self, key=None, example=None) -> Params:
        """Initial parameters: no threshold shift, the configured tau, and
        a channel mix that prefers alpha (the reference's default test
        channel). ``key`` and ``example`` are unused (the parameters are
        deterministic scalars) and kept for the usual init signature."""
        del key, example
        return {
            "threshold_bias": jnp.zeros((), jnp.float32),
            "log_tau": jnp.log(jnp.float32(self.soft.tau)),
            "channel_mix": jnp.array([0.0, 4.0], jnp.float32),
        }

    def apply(self, params: Params, img2ch: jnp.ndarray) -> jnp.ndarray:
        mix = jax.nn.softmax(params["channel_mix"])
        gray = (img2ch.astype(jnp.float32) * mix).sum(-1) - params["threshold_bias"]
        tau = jnp.exp(params["log_tau"])
        # fold the learnable tau into the pixel values so the soft cores
        # see a statically-configured pipeline: logits=(v-127.5)/tau_static,
        # with v pre-scaled — keeps tau differentiable without retracing.
        v = (gray - jnp.float32(127.5)) / tau * jnp.float32(self.soft.tau) + jnp.float32(127.5)
        if self.mesh is not None:
            return sharded_soft_sdf_field(
                v,
                self.spread,
                self.mesh,
                tau=self.soft.tau,
                temperature=self.soft.temperature,
                eps=self.soft.eps,
                batch_axis=self.batch_axis,
            )
        return softsdf.soft_sdf_field(
            v,
            self.spread,
            tau=self.soft.tau,
            temperature=self.soft.temperature,
            eps=self.soft.eps,
            precision=self.soft.precision,
        )


def create_train_state(
    model: SoftSDFModel, example: jnp.ndarray, lr: float = 1e-2
) -> Tuple[Any, Any, optax.GradientTransformation]:
    params = model.init(jax.random.key(0), example)
    tx = optax.adam(lr)
    opt_state = tx.init(params)
    return params, opt_state, tx


def make_train_step(model: SoftSDFModel, tx: optax.GradientTransformation):
    """Returns jittable train_step(params, opt_state, img2ch, target_sdf)
    -> (params, opt_state, loss). Loss is the mean squared error between
    the model's signed soft SDF and a target field."""

    def loss_fn(params, img2ch, target):
        pred = model.apply(params, img2ch)
        return jnp.mean((pred - target) ** 2)

    def train_step(params, opt_state, img2ch, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, img2ch, target)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
