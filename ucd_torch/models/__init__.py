from .convert import flax_to_state_dict, state_dict_to_flax
from .segmentation import IncrementalSegmentationModel

__all__ = ["IncrementalSegmentationModel", "flax_to_state_dict",
           "state_dict_to_flax"]
