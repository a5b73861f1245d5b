"""Dataset-definition YAML parsing.

This is a compatibility surface: the recursive YAML format, its validation
errors (cycles, duplicates, class mismatches, missing paths), and the
train/test disjointness guarantees must match the reference
(reference: yogo/data/dataset_definition_file.py:11-494, docs in its module
docstring). A definition file contains:

    class_names: [ ... ]                       # required
    dataset_paths:                             # specs keyed by arbitrary label
        some_name:
            image_path: /abs/path/images      # "literal specification"
            label_path: /abs/path/labels
        other_name:
            defn_path: other_defn.yml          # "recursive specification"
                                               # (relative to this file's dir)
    test_paths: { ... same shape ... }         # optional, held-out test data
    dataset_split_fractions: {train: .75, val: .25}   # optional
    thumbnail_augmentation: {class_name: /path}       # optional

Only trees are accepted (cycle + duplicate detection); test specs must be
disjoint from train specs. Parsed with PyYAML (safe load) where it is
installed; without it a definition written as JSON still loads.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple, Union

from yogo_tpu_torch.data.split_fractions import SplitFractions


class InvalidDatasetDefinitionFile(Exception):
    ...


@dataclass(frozen=True)
class LiteralSpecification:
    """One (image dir, label dir) pair. Hashable for duplicate detection."""

    image_path: Path
    label_path: Path

    @classmethod
    def from_dict(cls, dct: Dict[str, str]) -> "LiteralSpecification":
        if len(dct) != 2:
            raise InvalidDatasetDefinitionFile(
                f"LiteralSpecification must have two keys; found {len(dct)}"
            )
        if "image_path" not in dct or "label_path" not in dct:
            raise InvalidDatasetDefinitionFile(
                "LiteralSpecification must have keys 'image_path' and 'label_path'"
            )
        return cls(Path(dct["image_path"]), Path(dct["label_path"]))

    def to_dict(self) -> Dict[str, str]:
        return {
            "image_path": str(self.image_path),
            "label_path": str(self.label_path),
        }


class SpecKey(Enum):
    DATASET_PATHS = "dataset_paths"
    TEST_DATASET_PATHS = "test_paths"
    ALL_DATASET_PATHS = "all_paths"


def _load_yaml(path: Path) -> Dict[str, Any]:
    """Parse a definition file with PyYAML where it is installed. JSON is a
    subset of YAML, so without PyYAML a definition written as JSON still
    loads; any other file then raises, naming the missing package."""
    text = Path(path).read_text()
    try:
        import yaml
    except ImportError:
        import json

        try:
            data = json.loads(text) if text.strip() else None
        except json.JSONDecodeError as e:
            raise InvalidDatasetDefinitionFile(
                f"{path}: PyYAML is not installed, and without it only "
                f"definitions written as JSON can be read ({e})"
            ) from e
    else:
        data = yaml.safe_load(text)
    if data is None:
        raise InvalidDatasetDefinitionFile(f"empty dataset definition file: {path}")
    return data


@dataclass
class DatasetDefinition:
    """Flattened, validated dataset definition."""

    _dataset_paths: Set[LiteralSpecification]
    _test_dataset_paths: Set[LiteralSpecification]
    classes: List[str]
    thumbnail_augmentation: Optional[Dict[str, Union[Path, List[Path]]]]
    split_fractions: SplitFractions

    @property
    def dataset_paths(self) -> List[LiteralSpecification]:
        return sorted(self._dataset_paths, key=lambda s: str(s.image_path))

    @property
    def test_dataset_paths(self) -> List[LiteralSpecification]:
        return sorted(self._test_dataset_paths, key=lambda s: str(s.image_path))

    @property
    def all_dataset_paths(self) -> List[LiteralSpecification]:
        return sorted(
            self._dataset_paths | self._test_dataset_paths,
            key=lambda s: str(s.image_path),
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DatasetDefinition):
            return False
        return (
            self._dataset_paths == other._dataset_paths
            and self._test_dataset_paths == other._test_dataset_paths
            and self.classes == other.classes
            and self.thumbnail_augmentation == other.thumbnail_augmentation
            and self.split_fractions == other.split_fractions
        )

    def __add__(self, other: "DatasetDefinition") -> "DatasetDefinition":
        """Concatenate two definitions; classes / thumbnail augmentation /
        split fractions must match (reference:
        yogo/data/dataset_definition_file.py:251-279)."""
        if self.classes != other.classes:
            raise ValueError(
                "cannot concatenate two dataset definitions with different classes"
            )
        if self.thumbnail_augmentation != other.thumbnail_augmentation:
            raise ValueError(
                "cannot concatenate two dataset definitions with different "
                "thumbnail augmentation"
            )
        if self.split_fractions != other.split_fractions:
            raise ValueError(
                "cannot concatenate two dataset definitions with different "
                "split fractions"
            )
        return DatasetDefinition(
            _dataset_paths=self._dataset_paths | other._dataset_paths,
            _test_dataset_paths=self._test_dataset_paths
            | other._test_dataset_paths,
            classes=self.classes,
            thumbnail_augmentation=self.thumbnail_augmentation,
            split_fractions=self.split_fractions,
        )

    # ------------------------------------------------------------------ load
    @classmethod
    def from_yaml(cls, path: Union[str, Path]) -> "DatasetDefinition":
        path = Path(path)
        data = _load_yaml(path)

        test_paths_present = "test_paths" in data

        try:
            classes = data["class_names"]
        except KeyError as e:
            raise InvalidDatasetDefinitionFile(
                "`class_names` is a required key in the dataset definition file"
            ) from e

        if test_paths_present:
            dataset_specs = cls._load_specs(
                path, classes, paths_key=SpecKey.DATASET_PATHS
            )
            test_specs = cls._load_specs(
                path,
                classes,
                exclude_ymls=(path,),
                exclude_specs=dataset_specs,
                paths_key=SpecKey.TEST_DATASET_PATHS,
            )
        else:
            dataset_specs = cls._load_specs(
                path, classes, paths_key=SpecKey.ALL_DATASET_PATHS
            )
            test_specs = set()

        cls._check_paths_exist(dataset_specs)
        cls._check_paths_exist(test_specs)

        if "dataset_split_fractions" in data:
            split_fractions = SplitFractions.from_dict(
                data["dataset_split_fractions"],
                test_paths_present=test_paths_present,
            )
        else:
            split_fractions = SplitFractions.train_only()

        return cls(
            _dataset_paths=dataset_specs,
            _test_dataset_paths=test_specs,
            classes=classes,
            thumbnail_augmentation=cls._load_thumbnails(classes, data),
            split_fractions=split_fractions,
        )

    # ------------------------------------------------------------- internals
    @staticmethod
    def _extract_specs(
        yml_path: Path, paths_key: SpecKey
    ) -> Tuple[List[str], List[Dict[str, str]]]:
        data = _load_yaml(yml_path)
        try:
            classes = data["class_names"]
        except KeyError:
            raise InvalidDatasetDefinitionFile(
                "`class_names` is a required key in the dataset definition file"
            )
        if paths_key == SpecKey.ALL_DATASET_PATHS:
            specs = list(
                data.get(SpecKey.DATASET_PATHS.value, {}).values()
            ) + list(data.get(SpecKey.TEST_DATASET_PATHS.value, {}).values())
        elif paths_key.value not in data:
            specs = []
        else:
            specs = list(data[paths_key.value].values())
        return classes, specs

    @classmethod
    def _load_specs(
        cls,
        yml_path: Path,
        classes: List[str],
        exclude_ymls: Tuple[Path, ...] = (),
        exclude_specs: Set[LiteralSpecification] = frozenset(),
        paths_key: SpecKey = SpecKey.DATASET_PATHS,
    ) -> Set[LiteralSpecification]:
        literal_defns: Set[LiteralSpecification] = set()

        spec_classes, specs = cls._extract_specs(yml_path, paths_key)
        if spec_classes != classes:
            raise InvalidDatasetDefinitionFile(f"classes mismatch in {yml_path}")

        for spec in specs:
            if "defn_path" in spec:
                child_path = Path(spec["defn_path"])
                if not child_path.is_absolute():
                    child_path = yml_path.parent / child_path

                if child_path in exclude_ymls:
                    raise InvalidDatasetDefinitionFile(
                        f"cycle found: {spec['defn_path']} is duplicated"
                    )

                child_specs = cls._load_specs(
                    child_path,
                    classes,
                    exclude_ymls=(child_path, *exclude_ymls),
                    paths_key=paths_key,
                )

                if dup := literal_defns & child_specs:
                    raise InvalidDatasetDefinitionFile(
                        f"duplicate dataset paths found: {dup}"
                    )
                literal_defns |= child_specs
            elif "image_path" in spec and "label_path" in spec:
                literal = LiteralSpecification.from_dict(spec)
                if literal in literal_defns:
                    raise InvalidDatasetDefinitionFile(
                        f"duplicate dataset paths found: {literal}"
                    )
                literal_defns.add(literal)
            else:
                raise InvalidDatasetDefinitionFile(
                    f"Invalid spec in dataset_paths: {spec}"
                )

        if duplicates := literal_defns & exclude_specs:
            raise InvalidDatasetDefinitionFile(
                "duplicate literal definition found in exclude paths!\n"
                f"duplicates are: {duplicates}"
            )

        return literal_defns

    @staticmethod
    def _load_thumbnails(
        classes: List[str], data: Dict[str, Any]
    ) -> Optional[Dict[str, Union[Path, List[Path]]]]:
        if "thumbnail_augmentation" not in data:
            return None
        mapping = data["thumbnail_augmentation"]
        if not isinstance(mapping, dict):
            raise InvalidDatasetDefinitionFile(
                "thumbnail_augmentation must map class names to paths to "
                "thumbnail directories (e.g. `misc: /path/to/thumbnails/misc`)"
            )
        for k in mapping:
            if k not in classes:
                raise InvalidDatasetDefinitionFile(
                    f"thumbnail_augmentation class {k} is not a valid class name"
                )
        return {
            k: v if isinstance(v, list) else [Path(v)] for k, v in mapping.items()
        }

    @staticmethod
    def _check_paths_exist(
        specs: Set[LiteralSpecification], prune: bool = False
    ) -> Set[LiteralSpecification]:
        to_prune: Set[LiteralSpecification] = set()
        for spec in specs:
            ok = (
                spec.image_path.is_dir()
                and spec.label_path.is_dir()
                and any(spec.label_path.iterdir())
            )
            if not ok:
                msg = (
                    "image_path or label_path do not lead to a directory, or "
                    "there are no labels.\n"
                    f"image_path={spec.image_path}\n"
                    f"label_path={spec.label_path}\n"
                )
                if prune:
                    warnings.warn(msg + "will prune.")
                    to_prune.add(spec)
                else:
                    raise FileNotFoundError(msg)
        specs -= to_prune
        return specs
