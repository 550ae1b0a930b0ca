"""Config-merging CLI parser.

Same resolution pipeline as the reference's Tap-based Parser
(ddpo/utils/parser.py:58-230), reimplemented on argparse (typed-argument-
parser is not available here):

  1. import the config module, take base[experiment],
  2. overlay dataset["common"] then dataset[experiment] (dataset name
     '-' -> '_'),
  3. overlay raw CLI --key value extras, type-coerced against the existing
     value,
  4. resolve "f:"-prefixed lazy f-strings against the merged namespace
     (e.g. "f:models/{iteration+1}" — how RWR iterations chain),
  5. seed: base_seed (rank 0's, broadcast when drawn) + the rank,
  6. savepath = logbase/savepath (+ mkdir when local); loadpath/modelpath
     joined under logbase unless absolute,
  7. provenance: git commit + diff snapshot, args.json dump (rank 0).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import random
from typing import Any, Dict, Optional

import numpy as np
import torch.distributed

from ddpo_torch.parallel.collectives import process_count, process_index
from ddpo_torch.utils import filesystem as fs
from ddpo_torch.utils.git_utils import get_git_rev, save_git_diff
from ddpo_torch.utils.logger import init_logging


class Args:
    """Attribute-dict for resolved config values."""

    def __init__(self, values: Dict[str, Any]):
        self._dict = dict(values)
        for key, val in values.items():
            setattr(self, key, val)

    def set(self, key: str, val: Any) -> None:
        setattr(self, key, val)
        self._dict[key] = val

    def __repr__(self):
        body = "\n".join(f"    {k}: {v}" for k, v in self._dict.items())
        return f"Args(\n{body}\n)"


def _coerce(val: str, old: Any) -> Any:
    if val == "None":
        return None
    if val == "latest":
        return "latest"
    if isinstance(old, (bool, list, tuple, dict)) or old is None:
        try:
            return eval(val)  # noqa: S307 - reference-compatible CLI coercion
        except Exception:
            return val
    if old is not None:
        try:
            return type(old)(val)
        except (TypeError, ValueError):
            return val
    return val


def lazy_fstring(template: str, args: Args) -> str:
    """Evaluate "models/{iteration+1}" against the args namespace."""
    expr = template.replace("{", "{args.")
    return eval(f"f'{expr}'", {"args": args})  # noqa: S307


class Parser:
    """parse_args(experiment) -> Args; subclass to set defaults."""

    config: str = "ddpo_torch.config.base"
    dataset: str = "compressed_animals"

    def parse_args(
        self, experiment: str, argv: Optional[list] = None, setup: bool = True
    ) -> Args:
        ap = argparse.ArgumentParser(allow_abbrev=False)
        ap.add_argument("--config", default=self.config)
        ap.add_argument("--dataset", default=self.dataset)
        known, extras = ap.parse_known_args(argv)

        args = self._read_config(known.config, known.dataset, experiment)
        args.set("config", known.config)
        args.set("dataset", known.dataset)
        self._add_extras(args, extras)
        self._eval_fstrings(args)
        if setup:
            self._set_seed(args)
            self._set_paths(args)
            self._provenance(args)
            init_logging("ddpo_torch", getattr(args, "verbose", False))
            self._save_args(args)
        print(f"[ parser ] {known.dataset}:{experiment}")
        for key, val in args._dict.items():
            print(f"    {key}: {val}")
        return args

    @staticmethod
    def _read_config(config: str, dataset: str, experiment: str) -> Args:
        dataset = dataset.replace("-", "_")
        module = importlib.import_module(config)
        params = dict(getattr(module, "base")[experiment])
        if hasattr(module, dataset):
            dataset_dict = getattr(module, dataset)
            params.update(dataset_dict.get("common", {}))
            params.update(dataset_dict.get(experiment, {}))
        return Args(params)

    @staticmethod
    def _add_extras(args: Args, extras: list) -> None:
        if not extras:
            return
        assert len(extras) % 2 == 0, f"odd number of CLI extras: {extras}"
        for i in range(0, len(extras), 2):
            key = extras[i].replace("--", "")
            assert hasattr(args, key), f"--{key} not in config"
            old = getattr(args, key)
            args.set(key, _coerce(extras[i + 1], old))

    @staticmethod
    def _eval_fstrings(args: Args) -> None:
        for key, val in list(args._dict.items()):
            if isinstance(val, str) and val.startswith("f:"):
                args.set(key, lazy_fstring(val[2:], args))

    @staticmethod
    def _set_seed(args: Args) -> None:
        """base_seed is the same on every rank (model init: replicas start
        equal); seed = base_seed + dp_index (prompts, shuffles, sampler
        noise: each dp group draws its own), as ddpo_tpu/utils/parser.py:
        140-150 with one rank a device. dp_index is rank // (mesh_sp *
        mesh_tp) (the ranks of one dp index are consecutive,
        parallel/mesh.py), so the sp and tp ranks of a dp index draw the
        same prompts and noise. An unset --seed is drawn on rank 0 and
        broadcast."""
        seed = getattr(args, "seed", None)
        if seed is None:
            seed = int(np.random.randint(0, int(1e6)))
            if process_count() > 1:
                box = [seed]
                torch.distributed.broadcast_object_list(box, src=0)
                seed = box[0]
        args.set("base_seed", seed)
        seed = seed + process_index() // (getattr(args, "mesh_sp", 1)
                                          * getattr(args, "mesh_tp", 1))
        args.set("seed", seed)
        random.seed(seed)
        np.random.seed(seed)

    @staticmethod
    def _set_paths(args: Args) -> None:
        if hasattr(args, "logbase") and hasattr(args, "savepath"):
            savepath = os.path.join(args.logbase, args.savepath)
            args.set("savepath", savepath)
            if not fs.is_remote(savepath):
                os.makedirs(savepath, exist_ok=True)
        for key in ("loadpath", "modelpath"):
            if hasattr(args, "logbase") and hasattr(args, key):
                val = getattr(args, key)
                if not val or val.startswith("/") or val.startswith("gs://"):
                    continue
                args.set(key, os.path.join(args.logbase, val))

    @staticmethod
    def _provenance(args: Args) -> None:
        args.set("commit", get_git_rev())
        try:
            if not fs.is_remote(args.savepath) and process_index() == 0:
                save_git_diff(os.path.join(args.savepath, "diff.txt"))
        except Exception:
            pass

    @staticmethod
    def _save_args(args: Args) -> None:
        savepath = getattr(args, "savepath", None)
        if savepath is None or fs.is_remote(savepath) or process_index() != 0:
            return
        os.makedirs(savepath, exist_ok=True)  # savepath may lack a logbase
        payload = {
            k: v for k, v in args._dict.items()
            if isinstance(v, (str, int, float, bool, list, dict, tuple, type(None)))
        }
        with open(os.path.join(savepath, "args.json"), "w") as f:
            json.dump(payload, f, indent=4, default=str)
