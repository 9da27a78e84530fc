"""Test configuration: run every test on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators via the standard
JAX trick (SURVEY.md §4): force the host platform and split it into 8
devices. Must run before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
