"""Core numeric kernels: the JAX-native replacement for the reference's C++
numeric stack (Pinocchio / Crocoddyl residuals / colmpc; SURVEY.md §2b).

Every function here is pure, jittable, differentiable and written for a
*fixed, compile-time* kinematic topology so XLA unrolls the tree traversal
and fuses it; batching is applied with ``jax.vmap`` at the call site.
"""
