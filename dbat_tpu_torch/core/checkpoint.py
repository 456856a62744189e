"""Checkpoint/resume: serialize Project state and solver traces
(counterpart of dbat_tpu/core/checkpoint.py, in the same .npz layout:
either package reads the other's files).

The reference has no built-in checkpointing (SURVEY.md §5); its
nearest feature is that the DBAT struct and the E info are plain data
saved/reloaded as .mat (postcovtest.m:18-21). Here a Project round-trips
through a single .npz, and a bundle can be resumed from any recorded
iteration of the solver trace (the deserialize-replay feature,
code/misc/deserialize.m:8-20).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .project import Project
from .serial import deserialize


def save_project(path: str, project: Project) -> None:
    arrays = {}
    meta = {}
    for f in dataclasses.fields(project):
        v = getattr(project, f.name)
        if isinstance(v, np.ndarray):
            arrays[f.name] = v
        elif isinstance(v, (int, float, str, bool)) or v is None:
            meta[f.name] = v
        elif isinstance(v, list):
            meta[f.name] = {"__list__": v}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_project(path: str) -> Project:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    kwargs = {}
    for f in dataclasses.fields(Project):
        if f.name in data:
            kwargs[f.name] = data[f.name]
        elif f.name in meta:
            v = meta[f.name]
            if isinstance(v, dict) and "__list__" in v:
                v = v["__list__"]
            kwargs[f.name] = v
    return Project(**kwargs)


def resume_x(info, iteration: int = -1) -> np.ndarray:
    """x vector at a recorded solver iteration (replay;
    ref deserialize.m:8-20)."""
    return np.asarray(info.trace[:, iteration])


def apply_iteration(project: Project, info, iteration: int = -1) -> Project:
    """Set project parameter state to a recorded solver iteration (host
    work: the trace and the project live on the host)."""
    x = torch.as_tensor(info.trace[:, iteration], dtype=torch.float64)
    io, eo, op = deserialize(info.spec, x, *(
        torch.as_tensor(a, dtype=torch.float64)
        for a in (project.io, project.eo, project.op)))
    out = project.copy()
    out.io, out.eo, out.op = io.numpy(), eo.numpy(), op.numpy()
    return out
