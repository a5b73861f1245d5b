"""Pluggable experiment logging: JSON-lines always, wandb when available.

The reference logs exclusively to wandb (rank-0 only, reference:
yogo/train.py:225-265,329-339). Here every run writes a local metrics.jsonl
(so tests and offline runs need no network) and mirrors to wandb when the
package is importable and enabled.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


def _wandb_or_none():
    try:
        import wandb

        return wandb
    except ImportError:
        return None


class RunLogger:
    def __init__(
        self,
        log_dir: Optional[Path] = None,
        config: Optional[Dict[str, Any]] = None,
        use_wandb: bool = True,
        wandb_entity: Optional[str] = None,
        wandb_project: Optional[str] = None,
        name: Optional[str] = None,
        notes: Optional[str] = None,
        tags: Optional[list] = None,
        enabled: bool = True,
        wandb_resume_id: Optional[str] = None,
    ):
        self.enabled = enabled
        self.log_dir = Path(log_dir) if log_dir else None
        self._jsonl = None
        self._pending: Dict[str, Any] = {}
        self.run_name = name
        self.wandb = None

        if not enabled:
            return

        if self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
            if config is not None:
                with open(self.log_dir / "config.json", "w") as f:
                    json.dump(config, f, indent=2, default=str)

        if use_wandb:
            wandb = _wandb_or_none()
            if wandb is not None:
                wandb.login(anonymous="allow")
                run = wandb.init(
                    config=config,
                    entity=wandb_entity,
                    project=wandb_project,
                    name=name,
                    notes=notes,
                    tags=tags,
                    # append to an existing run (yogo test --wandb-resume-id;
                    # reference: yogo/utils/test_model.py:47-52)
                    id=wandb_resume_id,
                    resume="allow" if wandb_resume_id is not None else None,
                )
                self.wandb = wandb
                if run is not None and name is None:
                    self.run_name = run.name

    def update_config(self, updates: Dict[str, Any]) -> None:
        if self.wandb is not None:
            self.wandb.config.update(updates, allow_val_change=True)
        if self._jsonl is not None:
            self._write({"_config_update": updates})

    def log(self, metrics: Dict[str, Any], step: int, commit: bool = True) -> None:
        """Buffer metrics for `step`; flush on commit OR when step advances.

        Mirrors wandb.log's real semantics (reference commits every 100
        steps, yogo/train.py:329-339): uncommitted rows belong to ONE step,
        and logging a different step flushes the previous row — without
        that, back-to-back per-step records with the same keys would
        overwrite each other and 99 of every 100 steps would be lost."""
        if not self.enabled:
            return
        if self._pending and self._pending.get("step") != step:
            self._flush_pending()
        self._pending.update(metrics)
        self._pending["step"] = step
        if commit:
            self._flush_pending()

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        self._write(self._pending)
        if self.wandb is not None:
            w = dict(self._pending)
            s = w.pop("step", None)
            self.wandb.log(w, step=s)
        self._pending = {}

    def summary(self, metrics: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        self._write({"_summary": metrics})
        if self.wandb is not None:
            for k, v in metrics.items():
                try:
                    self.wandb.summary[k] = v
                except Exception:
                    pass

    def _write(self, obj: Dict[str, Any]) -> None:
        if self._jsonl is not None:
            self._jsonl.write(
                json.dumps({"t": time.time(), **obj}, default=_jsonable) + "\n"
            )
            self._jsonl.flush()

    def finish(self) -> None:
        self._flush_pending()  # a trailing commit=False row must not be lost
        if self.wandb is not None:
            self.wandb.finish()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def _jsonable(x):
    import numpy as np

    if hasattr(x, "item") and getattr(x, "size", 2) == 1:
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)
