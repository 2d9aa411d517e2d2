"""Topic provisioning: the port's own copy of ``calfkit_tpu.provisioning``."""

from calfkit_tpu_torch.provisioning.provisioner import (
    ProvisioningConfig,
    classify_topic_error,
    framework_topics_for_nodes,
    provision,
    topics_for_nodes,
)

__all__ = [
    "ProvisioningConfig",
    "classify_topic_error",
    "framework_topics_for_nodes",
    "provision",
    "topics_for_nodes",
]
