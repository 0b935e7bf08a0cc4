"""repro_torch.nn — parameter specs, base layers and the Mamba2 block."""

from .module import ParamSpec, materialize, stack_specs  # noqa: F401
