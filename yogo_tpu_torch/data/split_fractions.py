"""Validated train/val/test split fractions.

Behavioral parity with the reference (reference:
yogo/data/split_fractions.py:8-111): range/sum validation, `test` key
rejected when test_paths exist, train_only default, integer partition sizes
with the remainder assigned to the last split (python round(), i.e. banker's
rounding, to match).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class InvalidSplitFraction(Exception):
    pass


class SplitFractions:
    def __init__(self, train: float, val: float, test: Optional[float]) -> None:
        self.train = train
        self.val = val
        self.test = test

        in_range = (
            0 <= self.train <= 1
            and 0 <= self.val <= 1
            and 0 <= (self.test or 0) <= 1
        )
        if not in_range:
            raise ValueError(
                "train, val, and test must be in range [0,1]; they are "
                f"{self.train}, {self.val}, and {self.test}"
            )
        if not abs(self.train + self.val + (self.test or 0) - 1) < 1e-10:
            raise ValueError(
                "train, val, and test must sum to 1; they sum to "
                f"{self.train + self.val + (self.test or 0)}"
            )

    def __repr__(self) -> str:
        return (
            f"SplitFractions(train={self.train}, val={self.val}, test={self.test})"
        )

    def __contains__(self, item: object) -> bool:
        return item in self.to_dict()

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SplitFractions):
            return False
        return (
            self.train == other.train
            and self.val == other.val
            and self.test == other.test
        )

    @classmethod
    def train_only(cls) -> "SplitFractions":
        return cls(1, 0, None)

    @classmethod
    def from_list(
        cls, lst: List[float], test_paths_present: bool = True
    ) -> "SplitFractions":
        if len(lst) != 3:
            raise InvalidSplitFraction(
                "SplitFractions.from_list's list must have length 3, but found "
                f"length {len(lst)}"
            )
        return cls.from_dict(
            dict(zip(["train", "val", "test"], lst)),
            test_paths_present=test_paths_present,
        )

    @classmethod
    def from_dict(
        cls, dct: Dict[str, float], test_paths_present: bool = True
    ) -> "SplitFractions":
        if test_paths_present and "test" in dct:
            raise InvalidSplitFraction(
                "when `test_paths` is present in a dataset descriptor file, "
                "'test' is not a valid key for `dataset_split_fractions`, since "
                "we will use all the data from `test_paths` for testing"
            )
        if not any(k in dct for k in ("train", "val", "test")):
            raise InvalidSplitFraction(
                "dct must have keys `train`, `val`, and `test` - found keys "
                f"{dct.keys()}"
            )
        if len(dct) > 3:
            raise InvalidSplitFraction(
                "dct must have keys `train`, `val`, and `test` only, but found "
                f"{len(dct)} keys"
            )
        return cls(dct["train"], dct["val"], dct.get("test", None))

    def to_dict(self) -> Dict[str, float]:
        d: Dict[str, float] = {}
        if self.train is not None:
            d["train"] = self.train
        if self.val is not None:
            d["val"] = self.val
        if self.test is not None:
            d["test"] = self.test
        return d

    def keys(self) -> List[str]:
        return list(self.to_dict().keys())

    def partition_sizes(self, total_size: int) -> Dict[str, int]:
        fracs = self.to_dict()
        keys = self.keys()
        sizes = {k: round(fracs[k] * total_size) for k in keys[:-1]}
        sizes[keys[-1]] = total_size - sum(sizes.values())

        if not all(sz >= 0 for sz in sizes.values()) or sum(
            sizes.values()
        ) != total_size:
            raise ValueError(
                f"could not create valid dataset split sizes: {sizes}, "
                f"full dataset size is {total_size}"
            )
        return sizes
