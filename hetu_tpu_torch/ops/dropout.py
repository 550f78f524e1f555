"""Dropout (counterpart of ``hetu_tpu/ops/dropout.py``) and the integer
seeds that drive it.

``hetu_tpu`` threads ``jax.random`` keys; the port threads plain integer
seeds. :func:`split_seed` derives independent child seeds on the host
(no device sync), a seed becomes a ``torch.Generator`` on the tensor's
device for :func:`dropout`, and the flash kernels read a seed from a
device word (their mask is a position hash, see ``ops/flash.py``). The
train step derives one seed per step, so a resumed run reproduces every
mask.

A captured step (``engine/train_step.py``) cannot take its seeds as
Python ints: the graph would replay the first step's masks forever. Its
body threads a :class:`StagedSeed` instead, a path of child indices
below the root of a :class:`SeedTable`. The host stages the step's root
seed before each run; every seed below it is derived on the host with
:func:`derive_seed`, as for an int, and reaches the device as a word of
``SeedTable.words`` (the flash kernels' operand) or as the seed of a
generator registered with the graph (residual dropout). So a replay at
step t draws exactly what the eager body draws at step t.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF

#: words a :class:`SeedTable` holds: one per flash seed of a step body
SEED_WORDS = 4096


def _int32(v: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    v &= _MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


class SeedTable:
    """The dropout seeds of one step body, staged on ``device``.

    ``seed()`` is the root (the step's seed), taken at the start of each
    run of the body. A body asks for
    :meth:`word` (the flash kernels' seed word) or :meth:`generator` (a
    generator for :func:`dropout`) by path; the first run of the body
    registers each, and :meth:`stage` refreshes all of them from a new
    root before every later run. A path drawn twice in one run (a
    checkpointed block's forward and its recompute) gets one generator
    per draw, each seeded alike, so both draw the same mask. While
    :attr:`frozen` (a capture) the body may only reuse what a run
    registered before."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.root = 0
        self.words = torch.zeros(SEED_WORDS, dtype=torch.int32,
                                 device=self.device)
        self.frozen = False
        self._slots: dict = {}        # path -> index of its word
        self._gens: dict = {}         # path -> [generator per draw]
        self._draws: dict = {}        # path -> draws in this run

    def seed(self) -> "StagedSeed":
        """The root, for one run of the body: each path's draws count
        from its first generator again."""
        self._draws = {}
        return StagedSeed(self, ())

    def value(self, path: tuple) -> int:
        v = self.root
        for i in path:
            v = derive_seed(v, i)
        return v

    def stage(self, root: int) -> None:
        """Refresh every registered seed from the root ``root`` (host
        work and one host-to-device copy; no device sync)."""
        self.root = int(root) & _MASK32
        for path, gens in self._gens.items():
            v = self.value(path)
            for g in gens:
                g.manual_seed(v)
        if self._slots:
            vals = [0] * len(self._slots)
            for path, i in self._slots.items():
                vals[i] = _int32(self.value(path))
            self.words[:len(vals)].copy_(
                torch.tensor(vals, dtype=torch.int32), non_blocking=True)

    def _new(self, what: str, path: tuple) -> None:
        if self.frozen:
            raise RuntimeError(f"dropout {what} {path} first drawn inside a "
                               f"capture: the run before it never drew it")

    def word(self, path: tuple) -> torch.Tensor:
        """The seed word of ``path``: a one-element int32 view of
        :attr:`words`."""
        i = self._slots.get(path)
        if i is None:
            self._new("word", path)
            i = len(self._slots)
            if i == SEED_WORDS:
                raise RuntimeError(f"a step body drew more than {SEED_WORDS}"
                                   f" flash seeds")
            self._slots[path] = i
            self.words[i].fill_(_int32(self.value(path)))
        return self.words[i:i + 1]

    def generator(self, path: tuple) -> torch.Generator:
        """The generator of the next draw of ``path`` in this run."""
        k = self._draws.get(path, 0)
        self._draws[path] = k + 1
        gens = self._gens.setdefault(path, [])
        if k == len(gens):
            self._new("generator", path)
            gens.append(torch.Generator(device=self.device).manual_seed(
                self.value(path)))
        return gens[k]

    def generators(self) -> list:
        return [g for gens in self._gens.values() for g in gens]


@dataclasses.dataclass(frozen=True)
class StagedSeed:
    """A seed below the root of ``table``: child ``path[0]`` of the
    root, then child ``path[1]`` of that, and so on."""

    table: SeedTable
    path: tuple

    def child(self, i: int) -> "StagedSeed":
        return StagedSeed(self.table, self.path + (int(i),))


Seed = Union[int, StagedSeed]


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive_seed(seed: Seed, i: int) -> Seed:
    """Child ``i`` of ``seed``: a 32-bit seed, independent of the
    siblings (splitmix64 over the pair)."""
    if isinstance(seed, StagedSeed):
        return seed.child(i)
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (i & _MASK64)) \
        & 0xFFFFFFFF


def split_seed(seed: Seed, n: int) -> list:
    """``n`` child seeds — the counterpart of ``jax.random.split``."""
    return [derive_seed(seed, i) for i in range(n)]


def generator_for(seed: Optional[Seed],
                  device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None → None); a
    staged seed's is its table's generator for this draw."""
    if seed is None:
        return None
    if isinstance(seed, StagedSeed):
        return seed.table.generator(seed.path)
    return torch.Generator(device=device).manual_seed(int(seed))


def seed_word(seed, device) -> Optional[torch.Tensor]:
    """The one-element int32 device word holding ``seed``'s 32 bits, as
    the flash kernels read it: a staged seed's word in its table, a
    tensor as it is, an int in a new tensor (None → None)."""
    if seed is None or isinstance(seed, torch.Tensor):
        return seed
    if isinstance(seed, StagedSeed):
        return seed.table.word(seed.path)
    return torch.tensor([_int32(int(seed))], dtype=torch.int32,
                        device=device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: survivors scaled by 1/(1-rate). ``rate <= 0`` or
    ``generator=None`` (eval, deterministic paths) is the identity."""
    if generator is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        raise ValueError(f"dropout rate must be < 1, got {rate}")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
                       ).to(x.dtype)
