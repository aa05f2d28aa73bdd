"""registry-drift: the lint registries must not rot.

pintlint's power comes from codebase-tuned registries
(analysis/config.py): LOCKED_CLASSES names the shared classes, the
module tuples name the instrumented / durable / kernel / serve-state
surfaces. Registries rot silently in both directions — a new class
grows an RLock and nobody registers it (its lock discipline is simply
never checked), or a file is renamed and its stale registry entry
matches nothing (the rule quietly stops running there). Both
directions are findings:

- a class that assigns ``self.X = threading.Lock()/RLock()`` but is
  not in ``LOCKED_CLASSES`` (checked whenever the scan's config has a
  non-empty registry — fixture configs with an empty one stay inert);
- registry entries in ``DURABLE_ARTIFACT_MODULES`` /
  ``KERNEL_DISPATCH_MODULES`` / ``SERVE_STATE_MODULES`` /
  ``OBS_INSTRUMENTED_MODULES`` matching no file, and
  ``LOCKED_CLASSES`` names with no class definition in the tree
  (checked only when the registry module itself is in the scan, so
  linting one file never claims the whole registry is stale). Paths
  are matched against the scan plus the configured tree roots.
"""

from __future__ import annotations

import os

from .core import Rule, iter_py_files, register


@register
class RegistryDriftRule(Rule):
    """An unregistered lock-owning class gets no lock-discipline
    checking at all; a stale registry entry silently un-checks a
    surface that used to be covered. Either way the contract decays
    with no signal — this rule makes drift loud."""

    id = "registry-drift"
    family = "registry"
    rationale = ("lock-owning classes missing from LOCKED_CLASSES and "
                 "registry entries matching nothing make lint "
                 "coverage rot silently")
    whole_program = True

    def check_project(self, project, index):
        config = project.config
        if config.locked_classes:
            self._check_unregistered(project, index)
        anchor = self._find_anchor(project)
        if anchor is not None:
            self._check_stale(project, index, anchor)

    # -- unregistered lock owners ---------------------------------------

    def _check_unregistered(self, project, index):
        config = project.config
        for qname in sorted(index.classes):
            cls = index.classes[qname]
            if not cls.lock_attrs:
                continue
            if cls.name in config.locked_classes:
                continue
            if any(m in "/" + cls.module.ctx.rel.replace(os.sep, "/")
                   for m in config.test_path_markers):
                continue
            attrs = ", ".join(sorted(cls.lock_attrs))
            cls.module.ctx.report(
                self.id, cls.node.lineno,
                f"class {cls.name} owns a lock ({attrs}) but is not "
                f"registered in LOCKED_CLASSES — its lock discipline "
                f"and lock ordering are unchecked")

    # -- stale registry entries -----------------------------------------

    def _find_anchor(self, project):
        suffix = project.config.registry_anchor_suffix
        if not suffix:
            return None
        for ctx in project.files:
            if ctx.path.endswith(suffix) or ctx.rel.endswith(suffix):
                return ctx
        return None

    def _known_paths(self, project):
        paths = set()
        for ctx in project.files:
            paths.add("/" + ctx.rel.replace(os.sep, "/"))
            paths.add("/" + ctx.path.replace(os.sep, "/").lstrip("/"))
        for root in project.config.registry_tree_roots:
            if not os.path.isdir(root):
                continue
            for path in iter_py_files([root]):
                rel = os.path.relpath(path, root)
                paths.add("/" + rel.replace(os.sep, "/"))
        return paths

    def _check_stale(self, project, index, anchor):
        config = project.config
        paths = self._known_paths(project)
        registries = (
            ("DURABLE_ARTIFACT_MODULES",
             config.durable_artifact_modules, "suffix"),
            ("KERNEL_DISPATCH_MODULES",
             config.kernel_dispatch_modules, "marker"),
            ("SERVE_STATE_MODULES",
             config.serve_state_modules, "suffix"),
            ("OBS_INSTRUMENTED_MODULES",
             config.obs_instrumented_modules, "suffix"),
        )
        for reg_name, entries, kind in registries:
            for entry in entries:
                if kind == "suffix":
                    hit = any(p.endswith(entry) for p in paths)
                else:
                    hit = any(entry in p for p in paths)
                if not hit:
                    anchor.report(
                        self.id, 1,
                        f"stale registry entry: {reg_name} lists "
                        f"'{entry}' but no file in the tree matches "
                        f"it — the rules it scopes silently check "
                        f"nothing")
        for name in sorted(config.locked_classes):
            if name not in index.classes_by_name:
                anchor.report(
                    self.id, 1,
                    f"stale registry entry: LOCKED_CLASSES lists "
                    f"'{name}' but no class with that name is "
                    f"defined in the tree")
