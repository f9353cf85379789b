"""Importers of checkpoints written outside this package."""

from asr_model_tpu_torch.compat.torch_import import (
    convert_state_dict, import_reference_checkpoint)

__all__ = ["convert_state_dict", "import_reference_checkpoint"]
