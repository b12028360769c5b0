from .ops import forest_predict, forest_predict_from_dense, pad_trees
from .ref import forest_predict_ref

__all__ = ["forest_predict", "forest_predict_from_dense", "forest_predict_ref",
           "pad_trees"]
