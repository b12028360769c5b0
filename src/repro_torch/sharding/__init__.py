from .rules import STRATEGIES, placements, replicated, spec_for_axes, tree_shardings

__all__ = ["STRATEGIES", "placements", "replicated", "spec_for_axes",
           "tree_shardings"]
