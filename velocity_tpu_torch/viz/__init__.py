"""Results visualization (torch twin of ``velocity_tpu/viz``)."""

from velocity_tpu_torch.viz.plots import plot_results, save_results_html  # noqa: F401
