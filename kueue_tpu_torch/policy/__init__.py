"""The pluggable admission-policy subsystem (port of kueue_tpu/policy).

See ``engine.py`` for the closed ``POLICY`` registry (first-fit / gavel
/ prema / deadline / gavel-deadline) and the compilation of declarative
workload inputs into the score tensors the batched kernels consume.
"""

from kueue_tpu_torch.policy.engine import (
    DEADLINE_BOOST_CAP,
    DEADLINE_LABEL,
    DEFAULT_POLICY,
    POLICY,
    REMAINING_SECONDS_LABEL,
    SCORE_SCALE,
    THROUGHPUT_LABEL_PREFIX,
    AdmissionPolicy,
    annotate_lowered,
    annotate_multi,
    policy_names,
    resolve_policy,
    workload_throughput,
)

__all__ = [
    "POLICY",
    "DEFAULT_POLICY",
    "AdmissionPolicy",
    "resolve_policy",
    "policy_names",
    "annotate_lowered",
    "annotate_multi",
    "workload_throughput",
    "THROUGHPUT_LABEL_PREFIX",
    "REMAINING_SECONDS_LABEL",
    "DEADLINE_LABEL",
    "SCORE_SCALE",
    "DEADLINE_BOOST_CAP",
]
