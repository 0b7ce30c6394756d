"""Experiment logger: leveled console logging + JSONL metrics + optional
TensorBoard / wandb mirrors, rank-0 gated.

The port's own copy of ucd_tpu/engine/logger.py. `metrics.jsonl` under the
log directory is always written (the machine-readable stream); tensorboardX
and wandb are used only when importable (wandb only when asked for), so a
headless host degrades to console + JSONL.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional


class Logger:
    def __init__(self, logdir: str, rank: int = 0, debug: bool = False,
                 summary: bool = True, step: Optional[int] = None,
                 use_wandb: bool = False):
        self.rank = rank
        self.step = step
        self.debug_flag = debug
        self.logdir = logdir
        self.writer = None
        self.jsonl = None

        logging.basicConfig(
            level=logging.DEBUG if debug else logging.INFO,
            format=f"[rank {rank}] %(levelname)s: %(message)s",
            stream=sys.stdout, force=False)
        self._log = logging.getLogger(f"ucd_torch.r{rank}")
        self._log.setLevel(logging.DEBUG if debug else logging.INFO)

        self.wandb = None
        if rank == 0:
            os.makedirs(logdir, exist_ok=True)
            self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
            if summary:
                try:
                    from tensorboardX import SummaryWriter
                    self.writer = SummaryWriter(logdir)
                except Exception:
                    self.writer = None
            # optional wandb mirror: the --wandb flag or UCD_TORCH_WANDB=1
            if use_wandb or os.environ.get("UCD_TORCH_WANDB") == "1":
                try:
                    import wandb
                    wandb.init(project="ucd_torch", dir=logdir)
                    self.wandb = wandb
                except Exception:
                    self.wandb = None

    def _tag(self, tag: str) -> str:
        # per-step tag suffix
        return f"{tag}/{self.step}" if self.step is not None else tag

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self.jsonl is not None:
            self.jsonl.close()

    # -- scalar/figure/table sinks (rank 0) -------------------------------
    def add_scalar(self, tag, value, step=None):
        if self.rank != 0:
            return
        if self.jsonl is not None:
            self.jsonl.write(json.dumps(
                {"tag": self._tag(tag), "value": float(value),
                 "step": step}) + "\n")
            self.jsonl.flush()
        if self.writer is not None:
            self.writer.add_scalar(self._tag(tag), float(value), step)
        if self.wandb is not None:
            self.wandb.log({self._tag(tag): float(value)})

    def add_image(self, tag, image, step=None):
        if self.rank == 0 and self.writer is not None:
            self.writer.add_image(self._tag(tag), image, step)

    def add_table(self, tag, tbl, step=None):
        if self.rank != 0:
            return
        if self.jsonl is not None:
            safe = {str(k): (v if isinstance(v, (int, float, str, bool))
                             else str(v)) for k, v in dict(tbl).items()}
            self.jsonl.write(json.dumps(
                {"tag": self._tag(tag), "table": safe, "step": step}) + "\n")
            self.jsonl.flush()
        if self.writer is not None:
            html = "<table><tbody>" + "".join(
                f"<tr><td>{k}</td><td>{v}</td></tr>"
                for k, v in dict(tbl).items()) + "</tbody></table>"
            self.writer.add_text(self._tag(tag), html, step)

    def add_results(self, results, step=None):
        self.add_table("Results", {k: str(v) for k, v in results.items()},
                       step)

    # -- console ----------------------------------------------------------
    def print(self, msg):
        print(msg, flush=True)

    def info(self, msg):
        if self.rank == 0:
            self._log.info(msg)

    def debug(self, msg):
        if self.rank == 0:
            self._log.debug(msg)

    def error(self, msg):
        self._log.error(msg)
