"""The port's nested cross-validation (``repro_torch.core.cv``) against the
reference's on the committed suite fixture: fold scores, chosen
hyperparameters, the inner grid search and leave-one-out, bit for bit; and
the port's copies of numpy-only reference modules differ from them only in
their docstrings and imports."""
import ast
from pathlib import Path

import jax  # noqa: F401  (the reference's package imports it)
import numpy as np
import pytest

from repro.core import cv as r_cv
from repro.core import split as r_split
from repro_torch.core import cv as p_cv
from repro_torch.core import split as p_split
from repro_torch.core.dataset import Dataset

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "suite_dataset_v1.json"
GRID = {"criterion": ["mse"], "max_features": ["max", "sqrt"],
        "n_estimators": [4, 8]}
CV = dict(grid=GRID, outer_folds=3, inner_folds=2, iterations=1)


@pytest.fixture(scope="module")
def data():
    ds = Dataset.load(FIXTURE).reduce_overrepresented()
    X, y, _ = ds.matrix("tpu-v5e", "time_us")
    return X.astype(np.float32), y


@pytest.mark.parametrize("time_split", [True, False])
def test_nested_cv_equal(data, time_split):
    X, y = data
    got = p_cv.nested_cv(X, y, p_cv.CVConfig(**CV, time_split=time_split))
    want = r_cv.nested_cv(X, y, r_cv.CVConfig(**CV, time_split=time_split))
    assert len(got.folds) == len(want.folds) == 3
    for a, b in zip(got.folds, want.folds):
        assert (a.iteration, a.fold, a.best_params, a.score, a.n_train,
                a.n_test) == (b.iteration, b.fold, b.best_params, b.score,
                              b.n_train, b.n_test)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.best_params_mode() == want.best_params_mode()
    strip = lambda s: {k: v for k, v in s.items() if k != "fit_seconds"}  # noqa: E731
    assert strip(got.summary()) == strip(want.summary())


def test_grid_search_equal(data):
    X, y = data
    pf = p_split.time_stratified_kfold(y, 3, np.random.default_rng(5))
    rf = r_split.time_stratified_kfold(y, 3, np.random.default_rng(5))
    got = p_cv.grid_search(X, y, pf, GRID, log_target=True, seed=2)
    want = r_cv.grid_search(X, y, rf, GRID, log_target=True, seed=2)
    assert got == want


def test_leave_one_out_equal(data):
    X, y = data
    params = {"criterion": "mse", "max_features": "sqrt", "n_estimators": 8}
    gi, gp = p_cv.leave_one_out(X, y, params, seed=3, max_samples=12)
    wi, wp = r_cv.leave_one_out(X, y, params, seed=3, max_samples=12)
    assert len(gi) == 12
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gp, wp)


def _body(path: Path) -> str:
    """The module's code without its docstring and imports."""
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body
            if not isinstance(n, (ast.Import, ast.ImportFrom))]
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("module", ["core/cv.py", "workloads/stream.py",
                                    "serve/refresh.py"])
def test_copy_differs_only_in_docstring_and_imports(module):
    assert (_body(REPO / "src" / "repro_torch" / module)
            == _body(REPO / "src" / "repro" / module))
