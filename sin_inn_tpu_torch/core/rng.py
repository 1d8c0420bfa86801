"""Explicit random streams as ``torch.Generator``s.

Every stochastic subsystem takes a named fold of one root generator, so runs
are reproducible and streams are independent regardless of execution order.
Names are hashed with the same blake2s digest as the reference package
(``sin_inn_tpu/core/rng.py``). The numbers differ from JAX's and need not
match: tests hand both packages the same numpy draws instead.
"""

from __future__ import annotations

import hashlib

import torch


def _name_hash(name: str) -> int:
    return int.from_bytes(
        hashlib.blake2s(name.encode(), digest_size=4).digest(), "little")


def _derive(gen: torch.Generator, tag: str) -> torch.Generator:
    """A new generator on ``gen``'s device, seeded from its seed and ``tag``."""
    digest = hashlib.blake2s(f"{gen.initial_seed()}/{tag}".encode(),
                             digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & (2 ** 63 - 1)
    return torch.Generator(device=gen.device).manual_seed(seed)


def root_generator(seed: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def named_fold(gen: torch.Generator, name: str) -> torch.Generator:
    """Fold a stable 32-bit hash of ``name`` into ``gen``'s seed."""
    return _derive(gen, f"name:{_name_hash(name)}")


def step_fold(gen: torch.Generator, step: int) -> torch.Generator:
    return _derive(gen, f"step:{int(step)}")
