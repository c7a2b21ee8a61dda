"""In-process serving frontend.

The thinnest way to serve a trained booster from the same process —
embeds a `ModelRegistry` (or wraps an existing one) and exposes the
batched predict path the HTTP frontend uses, minus the HTTP:

    client = ServingClient(booster)               # or a model-file path
    client = ServingClient(path, params={"device_type": "cpu"})
    probs = client.predict(X)                     # micro-batched
    client.load("canary", "other_model.txt")      # more models
    client.predict(X, model="canary", raw_score=True)
    client.close()
"""
from __future__ import annotations

from typing import List, Optional, Union

from .registry import ModelRegistry, ServingModel


class ServingClient:
    """Registry-backed in-process client."""

    def __init__(self, model: Union[str, object, None] = None,
                 params: Optional[dict] = None, name: str = "default",
                 registry: Optional[ModelRegistry] = None,
                 warmup: Optional[bool] = None):
        self.registry = registry if registry is not None \
            else ModelRegistry(params)
        self._owns_registry = registry is None
        if model is not None:
            self.registry.load(name, model, warmup=warmup)

    def load(self, name: str, model: Union[str, object], *,
             warmup: Optional[bool] = None) -> ServingModel:
        return self.registry.load(name, model, warmup=warmup)

    def unload(self, name: str) -> None:
        self.registry.unload(name)

    def models(self) -> List[str]:
        return self.registry.names()

    def status(self) -> dict:
        """Registry health snapshot — model names plus stale/demoted
        entries and per-entry device bytes (the `/healthz` body)."""
        return self.registry.status()

    def predict(self, X, model: str = "default", raw_score: bool = False,
                timeout: Optional[float] = None, trace=None):
        """Micro-batched predict.  `trace` takes a
        `telemetry.RequestTrace` (the HTTP frontend passes one carrying
        the caller's `X-Request-Id`); in-process callers can omit it —
        the batcher creates one per request."""
        return self.registry.predict(X, model=model, raw_score=raw_score,
                                     timeout=timeout, trace=trace)

    def close(self) -> None:
        if self._owns_registry:
            self.registry.close()

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
