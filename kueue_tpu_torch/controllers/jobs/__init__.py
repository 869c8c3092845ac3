"""Built-in job integrations (pkg/controller/jobs/*): the plain batch
Job and the pod group. The other integrations (JobSet, Kubeflow, Ray,
AppWrapper, replica and serving workloads) are still to port."""

from kueue_tpu_torch.controllers.jobs.batch_job import BatchJob
from kueue_tpu_torch.controllers.jobs.pod import PodGroup, SimPod

__all__ = ["BatchJob", "PodGroup", "SimPod"]
