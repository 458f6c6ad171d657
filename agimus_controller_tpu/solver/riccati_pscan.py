"""Horizon-parallel Riccati via `jax.lax.associative_scan`.

The sequential backward Riccati pass is O(T) depth — the one serial part of
the solver (the reference's mim_solvers has the same bottleneck; SURVEY.md §5
"long-context" flags the associative-scan composition as the parallel
answer, cf.
PAPERS.md "The Parallelization of Riccati Recursion" and Särkkä &
García-Fernández's parallel LQT).

Formulation: each LQR stage k (after eliminating the control cross term)
contributes a conditional-value-function element

    e_k = (A_k, b_k, C_k, eta_k, J_k)

with A = F~x, b = gap + Fu luu^-1 lu-shift, C = Fu luu^-1 Fu^T,
eta/-J the value linear/quadratic parts of the stage cost. The composition

    e1 (x) e2:   D  = (I + C1 J2)^-1
        A = A2 D A1
        b = A2 D (b1 + C1 eta2') + b2         (eta2' = -linear term conv.)
        C = A2 D C1 A2^T + C2
        eta = A1^T E (eta2 - J2 b1) + eta1    (E = (I + J2 C1)^-1)
        J = A1^T E J2 A1 + J1

is associative, so `associative_scan` evaluates all suffix compositions in
O(log T) depth; value functions at every node come out at once, and gains
are recovered with one vmapped pass. Exact same math as the sequential
sweep — validated against it to machine precision in tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class _Elem(NamedTuple):
    A: jnp.ndarray  # [T, nx, nx]
    b: jnp.ndarray  # [T, nx]
    C: jnp.ndarray  # [T, nx, nx]
    eta: jnp.ndarray  # [T, nx]
    J: jnp.ndarray  # [T, nx, nx]


def _combine(e2: _Elem, e1: _Elem) -> _Elem:
    """Compose e1 (earlier in time) with e2 (later): reverse-time scan uses
    flipped argument order."""
    nx = e1.A.shape[-1]
    eye = jnp.eye(nx, dtype=e1.A.dtype)
    mv = lambda M, v: jnp.einsum("...ij,...j->...i", M, v)
    D = jnp.linalg.solve(eye + e1.C @ e2.J, jnp.broadcast_to(eye, e1.C.shape))
    E = jnp.linalg.solve(eye + e2.J @ e1.C, jnp.broadcast_to(eye, e1.C.shape))
    A2D = e2.A @ D
    A = A2D @ e1.A
    b = mv(A2D, e1.b + mv(e1.C, e2.eta)) + e2.b
    C = A2D @ e1.C @ jnp.swapaxes(e2.A, -1, -2) + e2.C
    A1TE = jnp.swapaxes(e1.A, -1, -2) @ E
    eta = mv(A1TE, e2.eta - mv(e2.J, e1.b)) + e1.eta
    J = A1TE @ e2.J @ e1.A + e1.J
    J = 0.5 * (J + jnp.swapaxes(J, -1, -2))
    return _Elem(A, b, C, eta, J)


def _stage_elements(lx, lu, lxx, lxu, luu, Fx, Fu, fs_next, reg):
    """Per-stage conditional-value elements (control eliminated)."""
    nu = lu.shape[-1]
    eye_u = jnp.eye(nu, dtype=lx.dtype)
    # eliminate the control at each stage (complete the square):
    # luu~ = luu + reg I ;  Kc = luu~^-1 lxu^T ; kc = luu~^-1 lu
    luu_r = luu + reg * eye_u
    Lc = jnp.linalg.cholesky(luu_r)
    solve_u = lambda Bm: jax.vmap(
        lambda L, bb: jax.scipy.linalg.cho_solve((L, True), bb))(Lc, Bm)
    lxuT = jnp.swapaxes(lxu, -1, -2)
    Kc = solve_u(lxuT)  # [T, nu, nx]
    kc = solve_u(lu)  # [T, nu]
    At = Fx - jnp.einsum("tij,tjk->tik", Fu, Kc)
    bt = fs_next - jnp.einsum("tij,tj->ti", Fu, kc)
    Ct = jnp.einsum("tij,tjk->tik", Fu, solve_u(jnp.swapaxes(Fu, -1, -2)))
    Jt = lxx - jnp.einsum("tji,tjk->tik", lxuT, Kc)
    Jt = 0.5 * (Jt + jnp.swapaxes(Jt, -1, -2))
    etat = -(lx - jnp.einsum("tji,tj->ti", lxuT, kc))
    return _Elem(A=At, b=bt, C=Ct, eta=etat, J=Jt)


def _terminal_element(term_lx, term_lxx):
    nx = term_lx.shape[-1]
    zero = jnp.zeros((nx, nx), term_lx.dtype)
    return _Elem(A=zero, b=jnp.zeros((nx,), term_lx.dtype), C=zero,
                 eta=-term_lx, J=term_lxx)


def _gains_at(t_lx, t_lu, t_lxx, t_lxu, t_luu, t_Fx, t_Fu, f_next,
              Vx_n, Vxx_n, reg):
    """Standard one-shot gain recovery at a node given V_{t+1}."""
    nu = t_lu.shape[-1]
    Vx_plus = Vx_n + Vxx_n @ f_next
    Qu = t_lu + t_Fu.T @ Vx_plus
    Qux = t_lxu.T + t_Fu.T @ Vxx_n @ t_Fx
    Quu = t_luu + t_Fu.T @ Vxx_n @ t_Fu + reg * jnp.eye(nu, dtype=t_lu.dtype)
    L = jnp.linalg.cholesky(Quu)
    kk = jax.scipy.linalg.cho_solve((L, True), Qu)
    KK = jax.scipy.linalg.cho_solve((L, True), Qux)
    return kk, KK, Qu, Qu @ kk, kk @ Quu @ kk


def parallel_riccati(lx, lu, lxx, lxu, luu, Fx, Fu, fs, term_lx, term_lxx, reg=0.0):
    """All-node value functions + gains in O(log T) depth.

    Inputs: per-node arrays `[T, ...]` (same data the sequential `_backward`
    consumes), gaps `fs [T+1, nx]` (fs[0] unused here), terminal lx/lxx.
    Returns (ks [T, nu], Ks [T, nu, nx], Vx [T+1, nx], Vxx [T+1, nx, nx]).

    Note: the FDDP gap folding `Vx+ = Vx + Vxx f` is reproduced by folding
    the gap into each element's `b` (the dynamics offset).
    """
    T, nx = lx.shape
    nu = lu.shape[-1]
    dtype = lx.dtype

    st = _stage_elements(lx, lu, lxx, lxu, luu, Fx, Fu, fs[1:], reg)
    At, bt, Ct, etat, Jt = st.A, st.b, st.C, st.eta, st.J

    # terminal element
    eT = jax.tree.map(lambda a: a[None], _terminal_element(term_lx, term_lxx))
    elems = _Elem(
        A=jnp.concatenate([At, eT.A]),
        b=jnp.concatenate([bt, eT.b]),
        C=jnp.concatenate([Ct, eT.C]),
        eta=jnp.concatenate([etat, eT.eta]),
        J=jnp.concatenate([Jt, eT.J]),
    )
    # suffix compositions in reverse time
    out = jax.lax.associative_scan(_combine, elems, reverse=True)
    Vxx = out.J  # [T+1, nx, nx]
    Vx = -out.eta  # convention: eta = -Vx

    # recover gains with the standard one-shot pass using V_{t+1}
    ks, Ks, Qus, d1_t, d2_t = jax.vmap(
        lambda *a: _gains_at(*a, reg))(
        lx, lu, lxx, lxu, luu, Fx, Fu, fs[1:], Vx[1:], Vxx[1:])
    return ks, Ks, Qus, Vx, Vxx, jnp.sum(d1_t), jnp.sum(d2_t)
