"""Configuration surface compatible with the reference's ``.conf`` files.

Same observable parsing as the JAX package's ``config.py`` (reference
util/config.py): ``ModelConf`` reads ``key=value`` files, ``OptionConf``
parses flag strings such as ``on -topN 10,20 -dir ./results/`` — including
the quirk that a token like ``-1`` whose tail ``isdigit()`` is a *value*,
not a flag (util/config.py:39). Errors raise :class:`ConfigError`.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

from .errors import ConfigError


class OptionConf:
    """Flag-string parser with reference semantics (util/config.py:29-66).

    The string is split on single spaces. A leading ``on``/``off`` token sets
    the main switch. A token starting with ``-``/``--`` whose remainder is not
    all digits opens a flag; its value is the join of all following tokens up
    to the next flag token.
    """

    def __init__(self, content: str):
        self.line: List[str] = content.strip().split(" ")
        self.options: Dict[str, str] = {}
        self.main_option = self.line[0] == "on"
        for i, item in enumerate(self.line):
            if self._is_flag(item):
                # count value tokens following the flag (reference loop,
                # util/config.py:40-47)
                ind = i + 1
                rest = self.line[ind:]
                for j, sub in enumerate(rest):
                    if self._is_flag(sub):
                        ind = j
                        break
                    if j == len(rest) - 1:
                        ind = j + 1
                        break
                self.options[item] = " ".join(self.line[i + 1 : i + 1 + ind])

    @staticmethod
    def _is_flag(token: str) -> bool:
        return (token.startswith("-") or token.startswith("--")) and not token[
            1:
        ].isdigit()

    # -- reference-compatible surface ------------------------------------
    def __getitem__(self, item: str) -> str:
        if not self.contains(item):
            raise ConfigError(f"parameter {item} is invalid!")
        return self.options[item]

    def keys(self):
        return self.options.keys()

    def contains(self, key: str) -> bool:
        return key in self.options

    def isMainOn(self) -> bool:  # noqa: N802 - reference-compatible name
        return self.main_option

    # -- typed helpers ----------------------------------------------------
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.options.get(key, default)

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        if not self.contains(key):
            if default is None:
                raise ConfigError(f"parameter {key} is invalid!")
            return default
        return float(self.options[key])

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        if not self.contains(key):
            if default is None:
                raise ConfigError(f"parameter {key} is invalid!")
            return default
        return int(self.options[key])

    def get_ints(self, key: str) -> List[int]:
        """Parse a comma-separated int list, e.g. ``-topN 10,20``."""
        return [int(tok) for tok in self[key].split(",")]


class ModelConf:
    """``key=value`` config-file parser (util/config.py:2-27).

    Accepts either a path to a ``.conf`` file or a prebuilt dict.
    """

    def __init__(self, source):
        self.config: Dict[str, str] = {}
        if isinstance(source, dict):
            self.config = {str(k): str(v) for k, v in source.items()}
        else:
            self._read(source)

    def _read(self, path: str) -> None:
        if not os.path.exists(path):
            raise ConfigError(f"config file is not found! ({path})")
        with open(path) as f:
            for ind, line in enumerate(f):
                if line.strip() == "":
                    continue
                # split only on the first '=' (the reference's plain
                # split('=') breaks on values containing '=')
                if "=" not in line:
                    raise ConfigError(
                        f"config file is not in the correct format! Error Line:{ind}"
                    )
                key, value = line.strip().split("=", 1)
                self.config[key] = value

    def __getitem__(self, item: str) -> str:
        if not self.contains(item):
            raise ConfigError(f"parameter {item} is invalid!")
        return self.config[item]

    def __setitem__(self, key: str, value: str) -> None:
        self.config[key] = str(value)

    def __iter__(self) -> Iterator[str]:
        return iter(self.config)

    def contains(self, key: str) -> bool:
        return key in self.config

    # -- typed helpers ----------------------------------------------------
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.config.get(key, default)

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        if not self.contains(key):
            if default is None:
                raise ConfigError(f"parameter {key} is invalid!")
            return default
        return int(self.config[key])

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        if not self.contains(key):
            if default is None:
                raise ConfigError(f"parameter {key} is invalid!")
            return default
        return float(self.config[key])

    def options(self, key: str) -> OptionConf:
        """Parse the value of ``key`` as an option string."""
        return OptionConf(self[key])

    def model_options(self) -> Optional[OptionConf]:
        """Model-specific parameter line, e.g. ``LightGCN=-n_layer 2``
        (reference: base/recommender.py:55-61). Read under the display name,
        then under its alias (``SVD++`` -> ``SVDPlusPlus``)."""
        name = self["model.name"]
        from .models import ALIASES  # local import: the models import this module

        for key in (name, ALIASES.get(name)):
            if key and self.contains(key):
                return OptionConf(self[key])
        return None
