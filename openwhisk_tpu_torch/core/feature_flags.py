"""Feature flags (ref common/scala/.../core/FeatureFlags.scala).

The reference exposes one flag, `whisk.feature-flags.require-api-key-annotation`
(application.conf feature-flags block): when enabled, newly *created* actions
that do not already declare the `provide-api-key` annotation have it stamped
`false` (Actions.scala:55-73), and the invoker withholds the API key from the
action container unless the annotation is truthy — with a missing annotation
treated as truthy for backward compatibility (ContainerProxy.scala:688-693).

Config channel: `CONFIG_whisk_featureFlags_requireApiKeyAnnotation=true`.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..utils.config import load_config

# ref common/scala/.../core/entity/Annotations.scala:26
PROVIDE_API_KEY_ANNOTATION = "provide-api-key"
# ref Actions.scala execAnnotation (WhiskAction.execFieldName)
EXEC_ANNOTATION = "exec"


@dataclass
class FeatureFlagConfig:
    require_api_key_annotation: bool = False


def feature_flags() -> FeatureFlagConfig:
    """Load the flags fresh from the env channel (cheap; keeps tests able to
    toggle flags without cache invalidation hooks)."""
    return load_config(FeatureFlagConfig, env_path="feature_flags")
