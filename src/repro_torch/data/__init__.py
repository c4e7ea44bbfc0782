from repro_torch.data.datasets import DATASETS, make_dataset
from repro_torch.data.workloads import WORKLOADS, WorkloadRunner

__all__ = ["make_dataset", "DATASETS", "WORKLOADS", "WorkloadRunner"]
