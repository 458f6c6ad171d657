"""Activation models: a(r) plus analytic first/second derivatives.

JAX-native equivalents of the activation surface the reference uses
(`crocoddyl.ActivationModelWeightedQuad`, `colmpc.ActivationModelExp` /
`ActivationModelQuadExp`; DSL nodes at `ocp/ocp_croco_generic.py:95-143`).

Each activation is a triple of pure functions over the residual vector r:
    value(r, w)  -> scalar a(r)
    dr(r, w)     -> [nr] gradient da/dr
    drr(r, w)    -> [nr] diagonal of d2a/dr2 (Gauss-Newton uses the diagonal;
                    matches crocoddyl's Arr convention for these activations)

``w`` is the runtime weight vector (ActivationModelWeightedQuad.weights —
mutated per tick in the reference, a plain array input here).
"""

from __future__ import annotations

import jax.numpy as jnp


def weighted_quad_value(r, w):
    """a(r) = 0.5 * sum_i w_i r_i^2."""
    return 0.5 * jnp.sum(w * r * r, axis=-1)


def weighted_quad_dr(r, w):
    return w * r


def weighted_quad_drr(r, w):
    return w


def exp_value(r, w, alpha):
    """colmpc ActivationModelExp (exponent=1): a(r) = exp(-||r|| / alpha).

    ``w`` unused (scalar-barrier activations carry no runtime weights)."""
    d = jnp.linalg.norm(r, axis=-1)
    return jnp.exp(-d / alpha)


def exp_dr(r, w, alpha):
    d = jnp.sqrt(jnp.sum(r * r, axis=-1, keepdims=True) + 1e-12)
    return (-jnp.exp(-d / alpha) / (alpha * d)) * r


def exp_drr(r, w, alpha):
    d = jnp.sqrt(jnp.sum(r * r, axis=-1, keepdims=True) + 1e-12)
    # diagonal GN approximation of the true Hessian, kept PSD
    return jnp.broadcast_to(jnp.exp(-d / alpha) / (alpha * alpha), r.shape)


def quad_exp_value(r, w, alpha):
    """colmpc ActivationModelQuadExp (exponent=2): a(r) = exp(-||r||^2/alpha)
    (the YAML comment 'alpha: 1e-4 # 1cm squared' fixes the convention,
    `ocp/ocp_traj_tracking_collision_avoidance.yaml:44`)."""
    return jnp.exp(-jnp.sum(r * r, axis=-1) / alpha)


def quad_exp_dr(r, w, alpha):
    a = quad_exp_value(r, w, alpha)
    return (-2.0 / alpha) * a[..., None] * r


def quad_exp_drr(r, w, alpha):
    # PSD Gauss-Newton diagonal: keep only the positive (4 r^2/alpha^2) term
    a = quad_exp_value(r, w, alpha)
    return (4.0 / (alpha * alpha)) * a[..., None] * r * r


ACTIVATIONS = {
    "weighted_quad": (weighted_quad_value, weighted_quad_dr, weighted_quad_drr),
}
