"""Structured stdout logging (the port's own copy of
naruto_tpu/utils/printer.py).

Parity with the reference InfoPrinter (src/utils/general_utils.py:69-160):
lines of the form ``| [NAME] | scene | Step: i/N | Module | msg``.
"""
from __future__ import annotations

from typing import Optional


class InfoPrinter:
    def __init__(self, name: str = "NARUTO-TPU", total_step: int = 0,
                 scene: str = "", quiet: bool = False) -> None:
        self.name = name
        self.total_step = total_step
        self.scene = scene
        self.quiet = quiet

    def update_total_step(self, total_step: int) -> None:
        self.total_step = total_step

    def update_scene(self, scene: str) -> None:
        self.scene = scene

    @staticmethod
    def adjust_string_length(length: int, s: str) -> str:
        return s.ljust(length)[:max(length, len(s))]

    def __call__(self, msg: str, step: Optional[int] = None,
                 module: str = "") -> None:
        if self.quiet:
            return
        parts = [f"| [{self.name}]"]
        if self.scene:
            parts.append(f"| {self.scene}")
        if step is not None:
            parts.append(f"| Step: {step}/{self.total_step}")
        if module:
            parts.append(f"| {module}")
        parts.append(f"| {msg}")
        print(" ".join(parts), flush=True)
