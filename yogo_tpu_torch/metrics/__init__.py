from yogo_tpu_torch.metrics.metrics import Metrics  # noqa: F401
from yogo_tpu_torch.metrics.device_metrics import DeviceMetrics  # noqa: F401
from yogo_tpu_torch.metrics.mean_ap import MeanAveragePrecision  # noqa: F401
from yogo_tpu_torch.metrics.matching import linear_sum_assignment  # noqa: F401
