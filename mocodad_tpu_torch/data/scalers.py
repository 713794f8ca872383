"""NaN-aware feature scalers, NumPy-only.

Standalone re-implementations of the sklearn scalers the reference leans on
(RobustScaler(quantile_range=(10,90)) in utils/data.py:350-359 and
utils/dataset_utils.py:90-94; MinMaxScaler in utils/data.py:316-333;
the hand-rolled StdScaler in utils/dataset_utils.py:329-353).  Fitted
statistics are plain arrays so scalers persist as .npz checkpoint artifacts
(the reference pickles sklearn objects, utils/get_robust_data.py:13-21).

NaNs are treated as missing: ignored during fit, propagated by transform
(sklearn's allow-nan behaviour).
"""

from __future__ import annotations

import numpy as np


def _handle_zeros_in_scale(scale: np.ndarray) -> np.ndarray:
    """Constant features scale by 1.  sklearn (1.3, the reference's pin)
    treats any scale below 10*eps as constant — an exact-zero test would
    let a ~1e-16 round-off range blow a near-constant feature up by ~1e15
    instead of passing it through."""
    scale = np.asarray(scale, dtype=np.float64).copy()
    scale[np.abs(scale) < 10 * np.finfo(np.float64).eps] = 1.0
    return scale


class RobustScaler:
    """Median / quantile-range scaler (sklearn-equivalent for the
    reference's quantile_range=(10, 90) usage)."""

    def __init__(self, quantile_range=(10.0, 90.0)):
        self.quantile_range = quantile_range
        self.center_ = None
        self.scale_ = None

    def fit(self, X: np.ndarray) -> 'RobustScaler':
        X = np.asarray(X, dtype=np.float64)
        q_min, q_max = self.quantile_range
        self.center_ = np.nanmedian(X, axis=0)
        quantiles = np.nanpercentile(X, [q_min, q_max], axis=0)
        self.scale_ = _handle_zeros_in_scale(quantiles[1] - quantiles[0])
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.center_) / self.scale_

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return X * self.scale_ + self.center_

    def state(self) -> dict:
        return {'kind': 'robust', 'center': self.center_,
                'scale': self.scale_,
                'quantile_range': np.asarray(self.quantile_range)}

    @classmethod
    def from_state(cls, st: dict) -> 'RobustScaler':
        s = cls(tuple(np.asarray(st['quantile_range']).tolist()))
        s.center_ = np.asarray(st['center'])
        s.scale_ = np.asarray(st['scale'])
        return s


class MinMaxScaler:
    """Feature-range (0, 1) scaler (sklearn-equivalent; NaN-ignoring fit)."""

    def __init__(self, feature_range=(0.0, 1.0)):
        self.feature_range = feature_range
        self.data_min_ = None
        self.data_max_ = None
        self.scale_ = None
        self.min_ = None

    def fit(self, X: np.ndarray) -> 'MinMaxScaler':
        X = np.asarray(X, dtype=np.float64)
        lo, hi = self.feature_range
        self.data_min_ = np.nanmin(X, axis=0)
        self.data_max_ = np.nanmax(X, axis=0)
        rng = _handle_zeros_in_scale(self.data_max_ - self.data_min_)
        self.scale_ = (hi - lo) / rng
        self.min_ = lo - self.data_min_ * self.scale_
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return X * self.scale_ + self.min_

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.min_) / self.scale_

    def state(self) -> dict:
        return {'kind': 'zero_one', 'data_min': self.data_min_,
                'data_max': self.data_max_, 'scale': self.scale_,
                'min': self.min_,
                'feature_range': np.asarray(self.feature_range)}

    @classmethod
    def from_state(cls, st: dict) -> 'MinMaxScaler':
        s = cls(tuple(np.asarray(st['feature_range']).tolist()))
        s.data_min_ = np.asarray(st['data_min'])
        s.data_max_ = np.asarray(st['data_max'])
        s.scale_ = np.asarray(st['scale'])
        s.min_ = np.asarray(st['min'])
        return s


class StdScaler:
    """+-N-sigma scaler (ref: utils/dataset_utils.py:329-353)."""

    def __init__(self, stds: int = 3):
        self.stds = stds
        self.mu = None
        self.sigma = None

    def fit(self, X: np.ndarray) -> 'StdScaler':
        self.mu = np.nanmean(X, axis=0, keepdims=True)
        self.sigma = np.nanstd(X, axis=0, keepdims=True)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - (self.mu - self.stds * self.sigma)) / \
            (2 * self.stds * self.sigma)

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return X * (2 * self.stds * self.sigma) + \
            (self.mu - self.stds * self.sigma)

    def state(self) -> dict:
        return {'kind': 'three_stds', 'mu': self.mu, 'sigma': self.sigma,
                'stds': np.asarray(self.stds)}

    @classmethod
    def from_state(cls, st: dict) -> 'StdScaler':
        s = cls(int(np.asarray(st['stds'])))
        s.mu = np.asarray(st['mu'])
        s.sigma = np.asarray(st['sigma'])
        return s


_KINDS = {'robust': RobustScaler, 'zero_one': MinMaxScaler,
          'three_stds': StdScaler}


def save_scaler(scaler, path: str) -> None:
    np.savez(path, **scaler.state())


def load_scaler(path: str):
    with np.load(path, allow_pickle=False) as st:
        kind = str(st['kind'])
        return _KINDS[kind].from_state({k: st[k] for k in st.files})


def scale_trajectories(X: np.ndarray, scaler=None, strategy: str = 'zero_one'):
    """Scale flattened trajectory features, mapping exact zeros <-> missing
    (ref: utils/data.py:297-359).  Returns (X_scaled, scaler)."""
    original_shape = X.shape
    X = X.reshape(-1, original_shape[-1])

    if strategy == 'zero_one':
        if scaler is None:
            Xm = np.where(X == 0.0, np.nan, X)
            x_min = np.nanmin(Xm, axis=0, keepdims=True)
            x_min = np.where(np.isnan(x_min), 0.0, x_min)
            x_min_t = np.tile(x_min, (X.shape[0], 1))
            eps = 1e-3
            X_fit = np.where(np.isnan(np.where(X == 0.0, np.nan, X)),
                             x_min_t - eps, X)
            scaler = MinMaxScaler((0.0, 1.0)).fit(X_fit)
        X_scaled = np.where(X == 0.0,
                            np.tile(scaler.data_min_, (X.shape[0], 1)), X)
        X_scaled = scaler.transform(X_scaled)
    elif strategy == 'three_stds':
        Xm = np.where(X == 0.0, np.nan, X)
        if scaler is None:
            scaler = StdScaler(stds=3).fit(Xm)
        X_scaled = scaler.transform(Xm)
        X_scaled = np.where(np.isnan(X_scaled), 0.0, X_scaled)
    elif strategy == 'robust':
        Xm = np.where(X == 0.0, np.nan, X)
        if scaler is None:
            scaler = RobustScaler((10.0, 90.0)).fit(Xm)
        X_scaled = scaler.transform(Xm)
        X_scaled = np.where(np.isnan(X_scaled), 0.0, X_scaled)
    else:
        raise ValueError(
            'Unknown strategy. Please select zero_one, three_stds or robust.')

    return X_scaled.reshape(original_shape).astype(np.float64), scaler
