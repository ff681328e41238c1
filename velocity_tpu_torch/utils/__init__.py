"""Utilities: string helpers, profiling/observability."""

from velocity_tpu_torch.utils.profiling import StageTimer, trace  # noqa: F401
from velocity_tpu_torch.utils.strings import filename_split, print_dict  # noqa: F401
