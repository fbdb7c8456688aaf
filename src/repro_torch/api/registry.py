"""Live model-pool registry.

Replaces the frozen ``models_meta`` / ``model_indices`` dicts that used to be
baked into ``ScopeRouter.__init__``: the pool is now a runtime object that
models join (``add_model`` / ``onboard``) and leave (``remove_model``)
mid-session.  ``onboard`` is training-free — one fingerprinting pass over the
anchor set via ``FingerprintLibrary.onboard`` (SCOPE §3.1), never a weight
update.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

from repro_torch.core.fingerprint import Fingerprint, FingerprintLibrary
from repro_torch.data.worldsim import PoolModel, World


class PoolRegistry:
    def __init__(self, library: FingerprintLibrary,
                 models_meta: Optional[Mapping[str, PoolModel]] = None, *,
                 indices: Optional[Mapping[str, int]] = None):
        self.library = library
        self._meta: Dict[str, PoolModel] = {}
        self._indices: Dict[str, int] = {}
        indices = dict(indices) if indices else {}
        # auto-assigned indices start above every explicit one so indices
        # stay unique (the tokenizer still folds them mod NUM_MODEL_TOKENS,
        # so token aliasing is possible once a session burns >20 indices)
        self._next_index = max(indices.values(), default=-1) + 1
        for meta in (models_meta or {}).values():
            self.add_model(meta, index=indices.get(meta.name))

    # -- membership ----------------------------------------------------
    def add_model(self, meta: PoolModel, *, index: Optional[int] = None) -> int:
        """Register metadata; returns the model's serialization index.

        Re-adding an existing model updates its metadata but keeps its index
        (the estimator's model token must stay stable across a session).
        """
        if meta.name in self._meta:
            self._meta[meta.name] = meta
            return self._indices[meta.name]
        if index is None:
            index = self._next_index
        self._meta[meta.name] = meta
        self._indices[meta.name] = int(index)
        self._next_index = max(self._next_index, int(index)) + 1
        return self._indices[meta.name]

    def remove_model(self, name: str) -> None:
        """Take a model out of the routable pool.

        Its fingerprint stays in the library (history is cheap and makes
        re-adding free); its index is never reused within a session.
        """
        if name not in self._meta:
            raise KeyError(name)
        del self._meta[name]
        del self._indices[name]

    def onboard(self, world: World, name: str, *, seed: int = 0,
                meta: Optional[PoolModel] = None,
                refresh: bool = False) -> Fingerprint:
        """Training-free onboarding: register metadata + fingerprint pass.

        An existing fingerprint is reused unless ``refresh`` forces a new
        pass (e.g. the deployed model drifted).
        """
        meta = meta if meta is not None else world.models[name]
        self.add_model(meta)
        if name in self.library and not refresh:
            return self.library.get(name)
        return self.library.onboard(world, name, seed=seed)

    # -- lookups -------------------------------------------------------
    def models(self) -> List[str]:
        """Registered pool, in insertion order."""
        return list(self._meta)

    def routable(self) -> List[str]:
        """Registered models that also have a fingerprint."""
        return [m for m in self._meta if m in self.library]

    def meta(self, name: str) -> PoolModel:
        return self._meta[name]

    def index(self, name: str) -> int:
        return self._indices.get(name, 0)

    def __contains__(self, name: str) -> bool:
        return name in self._meta

    def __len__(self) -> int:
        return len(self._meta)
