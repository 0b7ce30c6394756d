from .convert import (flax_to_state_dict, load_flax_variables,
                      module_to_flax, state_dict_to_flax)
from .nonlocal_block import NonLocalBlock2D
from .segmentation import (IncrementalSegmentationModel, init_new_classifier,
                           make_model, merge_old_params, trainable_mask)

__all__ = ["IncrementalSegmentationModel", "NonLocalBlock2D",
           "flax_to_state_dict", "state_dict_to_flax", "load_flax_variables", "module_to_flax",
           "make_model", "init_new_classifier",
           "merge_old_params", "trainable_mask"]
