"""The `FSLMethod` API (``repro.core.methods``).  Importing this package
registers the four methods: ``cse_fsl``, ``fsl_mc``, ``fsl_oc`` and
``fsl_an``."""
from repro_torch.core.methods.base import (AsyncHooks, CommProfile,
                                           FSLMethod, assemble_round_step,
                                           available_methods, get_method,
                                           register)
from repro_torch.core.methods import (  # noqa: F401
    cse_fsl, fsl_an, fsl_mc, fsl_oc)

__all__ = ["AsyncHooks", "CommProfile", "FSLMethod", "assemble_round_step",
           "available_methods", "get_method", "register", "cse_fsl",
           "fsl_an", "fsl_mc", "fsl_oc"]
