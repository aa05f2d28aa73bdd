"""Durable-artifact write-discipline rule family.

- durable-write-unatomic: a truncating/creating ``open()`` (mode
  containing ``w`` or ``x``) in a module that owns crash-surviving
  artifacts — the checkpoint store, the request journal, the
  persisted executable cache, the flight recorder. A plain
  ``open(path, "w")`` truncates in place: a process killed between
  the truncate and the final flush leaves a torn file where the
  previous GOOD artifact used to be, which is precisely the data
  loss these modules exist to prevent. Durable modules must publish
  through ``pint_tpu_torch.durable`` (``atomic_write_bytes`` /
  ``atomic_write_text`` / ``atomic_write_json``: temp file + fsync +
  rename) or append-only modes. Read modes (``r``, ``rb``) and
  in-place patch mode (``r+b`` — the fault injectors' byte-flippers)
  are not write-publishes and stay legal.
"""

from __future__ import annotations

import ast

from .core import Rule, call_name, register


def _open_mode(node):
    """The mode-string constant of an ``open()`` call, or None when
    the mode is absent (default "r") or not a literal we can judge."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return None
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


@register
class DurableWriteUnatomicRule(Rule):
    id = "durable-write-unatomic"
    family = "durable"
    rationale = ("a truncating open() in a durable-artifact module "
                 "can tear the previous good artifact on a crash; "
                 "publish through pint_tpu_torch.durable atomic writes")

    def _applies(self, ctx):
        rel = "/" + ctx.rel.replace("\\", "/")
        suffixes = getattr(ctx.config, "durable_artifact_modules", ())
        return any(rel.endswith(s) for s in suffixes)

    def check_file(self, ctx):
        if not self._applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) not in ("open", "os.fdopen"):
                continue
            mode = _open_mode(node)
            if mode is None or not any(c in mode for c in "wx"):
                continue
            ctx.report(
                self.id, node,
                f"open(..., {mode!r}) in a durable-artifact module "
                "truncates in place: a crash mid-write tears the "
                "previous good copy. Publish through pint_tpu_torch."
                "durable.atomic_write_bytes/text/json (temp + fsync "
                "+ rename) instead")
