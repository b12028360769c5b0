from .ops import (PackedForest, forest_predict, forest_predict_from_dense,
                  forest_predict_packed, pack_tables)
from .ref import forest_predict_packed_ref, forest_predict_ref

__all__ = ["PackedForest", "forest_predict", "forest_predict_from_dense",
           "forest_predict_packed", "forest_predict_packed_ref",
           "forest_predict_ref", "pack_tables"]
