"""LM pose solvers and MSV triangulation."""
