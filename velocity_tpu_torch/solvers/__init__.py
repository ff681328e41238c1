"""LM pose solvers, MSV triangulation, the linear pose initializers and
bundle adjustment (dense, constrained, Schur)."""
