"""Abstract model base with save/load (counterpart of ``vlgp_tpu/base.py``)."""
from __future__ import annotations

import abc
import pathlib


class Model(abc.ABC):
    """Minimal estimator interface (reference base.py:6-29)."""

    @abc.abstractmethod
    def fit(self, *args, **kwargs):
        ...

    def save(self, path):
        from .utils.io import save_params

        return save_params(self.params, pathlib.Path(path))

    @classmethod
    def load(cls, path, device=None):
        """A model holding the params saved at ``path``, on ``device``
        (default: the CUDA device; raises when there is none)."""
        from .utils.io import load_params

        obj = cls.__new__(cls)
        obj.params = load_params(path, device=device)
        return obj


class VLGP(Model):
    """Thin sklearn-style wrapper over :func:`vlgp_tpu_torch.fit`; keyword
    arguments (``device`` among them) go to ``fit``."""

    def __init__(self, n_factors: int, **kwargs):
        self.n_factors = n_factors
        self.kwargs = kwargs
        self.result = None
        self.params = None

    def fit(self, trials):
        from .api import fit

        self.result = fit(trials, self.n_factors, **self.kwargs)
        self.params = self.result.params
        return self.result.trials

    def transform(self, trials):
        from .api import transform

        if self.result is None:
            raise ValueError(
                "This model is not fitted yet. Call 'fit' with appropriate "
                "arguments before this method."
            )
        return transform(trials, self.result, device=self.result.params.a.device)

    @property
    def weight(self):
        return None if self.params is None else self.params.a

    @property
    def bias(self):
        return None if self.params is None else self.params.b

    @property
    def isfitted(self) -> bool:
        return self.params is not None
