from xalm_tpu_torch.obs.table import Table  # noqa: F401
from xalm_tpu_torch.obs.profiler import profile, report, reset  # noqa: F401
from xalm_tpu_torch.obs.console import ProgressBar, SystemUsage, scoped_usage  # noqa: F401
