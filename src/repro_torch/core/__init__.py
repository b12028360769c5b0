"""repro_torch.core — the paper's predictor (Braun et al., 2020) for the
PyTorch/CUDA port.

``devices``, ``forest``, ``metrics``, ``split``, ``dataset``, ``simulate``,
``power``, ``scheduler`` and ``cv`` are numpy-only copies of their
``repro.core`` counterparts (the port must not import ``repro``, whose
``core`` package imports JAX); ``features`` extracts the 12 features from a
``torch.export`` graph, as the reference's does from StableHLO.
``forest_torch`` and ``latency`` are the torch counterparts of
``forest_jax`` and ``latency``; ``convert`` carries a fitted forest across
from the reference."""
from .convert import (dense_from_arrays, estimator_from_arrays,
                      lm_params_from_arrays)
from .cv import CVConfig, NestedCVResult, grid_search, leave_one_out, nested_cv
from .dataset import Dataset, Sample
from .devices import DEVICE_MODELS, SIMULATED_DEVICES, DeviceModel
from .features import (FEATURE_NAMES, N_FEATURES, FeatureVector, LaunchConfig,
                       OpTally, extract, extract_from_program)
from .forest import ExtraTreesRegressor, FlatForest, LinearBaseline, predict_flat
from .forest_torch import DenseForest, DenseForestTorch, FlatForestTorch, to_dense
from .metrics import error_buckets, mape, median_ape
from .power import simulate_power_mean_w, simulate_power_w
from .simulate import (AnalyticalBaseline, WorkloadSpec,
                       simulate_time_median_us, simulate_time_us)
from .split import plain_kfold, time_stratified_kfold

__all__ = [n for n in dir() if not n.startswith("_")]
