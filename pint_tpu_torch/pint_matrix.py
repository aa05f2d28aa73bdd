"""Labeled matrix objects: design, covariance, correlation.

(reference: src/pint/pint_matrix.py — PintMatrix, DesignMatrix,
CovarianceMatrix, combine_design_matrices_by_quantity/by_param.)

The numbers stay one dense array (a torch tensor on the fit's device,
or a host numpy array); labels and units are host-side metadata
carried alongside. The reference interleaves astropy units through the
matrix elements — here units are per-axis annotations validated at
combine time, so nothing unit-shaped ever reaches the device. The
torch counterpart of the JAX package's ``pint_matrix.py``.

Axis convention: axis 0 = quantity rows (e.g. "toa" residual rows,
"dm" residual rows), axis 1 = parameter columns. Each axis holds an
ordered list of (label, unit, (start, stop)) segments.
"""

from __future__ import annotations

import numpy as np
import torch


class PintMatrix:
    """Dense matrix + per-axis labeled segments
    (reference: pint_matrix.py::PintMatrix)."""

    def __init__(self, matrix, axis_labels):
        """axis_labels: list (one entry per axis) of ordered segment
        lists [(label, unit, (start, stop)), ...] covering the axis."""
        self.matrix = matrix
        self.axis_labels = [list(segs) for segs in axis_labels]
        for ax, segs in enumerate(self.axis_labels):
            end = 0
            for label, unit, (lo, hi) in segs:
                if lo != end:
                    raise ValueError(
                        f"axis {ax}: segment {label!r} starts at {lo}, "
                        f"expected {end} (segments must tile the axis)")
                end = hi
            if segs and end != matrix.shape[ax]:
                raise ValueError(
                    f"axis {ax}: segments cover {end} of "
                    f"{matrix.shape[ax]} entries")

    @property
    def shape(self):
        return tuple(self.matrix.shape)

    def labels(self, axis):
        return [label for label, _, _ in self.axis_labels[axis]]

    def units(self, axis):
        return [unit for _, unit, _ in self.axis_labels[axis]]

    def get_label(self, axis, label):
        """(label, unit, (start, stop)) for a named segment."""
        for seg in self.axis_labels[axis]:
            if seg[0] == label:
                return seg
        raise KeyError(f"axis {axis} has no segment {label!r}")

    def get_slice(self, axis, label):
        _, _, (lo, hi) = self.get_label(axis, label)
        return slice(lo, hi)

    def __repr__(self):
        segs = " x ".join(
            "[" + ",".join(self.labels(ax)) + "]"
            for ax in range(len(self.axis_labels)))
        return f"<{type(self).__name__} {self.shape} {segs}>"


def _host(a):
    """A host numpy view of a tensor or array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _param_segments(names, units):
    return [(n, u, (i, i + 1)) for i, (n, u) in enumerate(zip(names, units))]


class DesignMatrix(PintMatrix):
    """Rows = one labeled quantity block; columns = one per parameter
    (reference: pint_matrix.py::DesignMatrix).

    derivative_quantity: what the rows are (e.g. "toa" for time
    residual derivatives [s/param-unit], "dm" for DM derivatives).
    """

    def __init__(self, matrix, quantity, quantity_unit, param_names,
                 param_units):
        self.derivative_quantity = quantity
        super().__init__(matrix, [
            [(quantity, quantity_unit, (0, matrix.shape[0]))],
            _param_segments(param_names, param_units),
        ])

    @property
    def param_names(self):
        return self.labels(1)

    @property
    def param_units(self):
        return self.units(1)

    @classmethod
    def from_prepared(cls, prepared, model, incoffset=True):
        """Time-residual design matrix [s / param-unit] of a
        PreparedTiming (reference: TimingModel.designmatrix scaled by
        1/F0 the way the fitters consume it)."""
        M, labels = prepared.designmatrix(incoffset=incoffset)
        f0 = prepared.params0["F"][0]
        units = []
        for name in labels:
            if name == "Offset":
                units.append("s")
            else:
                units.append(f"s/({getattr(model, name).units or '1'})")
        return cls(M / f0, "toa", "s", labels, units)


class CovarianceMatrix(PintMatrix):
    """Square parameter covariance (reference:
    pint_matrix.py::CovarianceMatrix)."""

    def __init__(self, matrix, param_names, param_units=None):
        if param_units is None:
            param_units = [""] * len(param_names)
        segs = _param_segments(param_names, param_units)
        super().__init__(matrix, [segs, segs])

    @property
    def param_names(self):
        return self.labels(0)

    def sigmas(self):
        return np.sqrt(np.diag(_host(self.matrix)))

    def to_correlation(self) -> "CorrelationMatrix":
        """(reference: pint_matrix.py correlation conversion)."""
        s = self.sigmas()
        s = np.where(s == 0, 1.0, s)
        corr = _host(self.matrix) / np.outer(s, s)
        return CorrelationMatrix(corr, self.param_names)


class CorrelationMatrix(PintMatrix):
    def __init__(self, matrix, param_names):
        segs = _param_segments(param_names, [""] * len(param_names))
        super().__init__(matrix, [segs, segs])


def combine_design_matrices_by_quantity(matrices):
    """Stack design matrices of DIFFERENT quantities (e.g. time rows +
    DM rows) over the UNION of their parameter columns; a parameter
    absent from one quantity's matrix contributes zero rows there
    (reference: pint_matrix.py::combine_design_matrices_by_quantity).
    The matrices are torch tensors on one device. Unit consistency per shared parameter is enforced on the part after
    the quantity prefix.
    """
    all_params = []
    for m in matrices:
        for p in m.param_names:
            if p not in all_params:
                all_params.append(p)
    unit_of = {}
    for m in matrices:
        for p, u in zip(m.param_names, m.param_units):
            base = u.split("/", 1)[-1]
            if p in unit_of and unit_of[p] != base:
                raise ValueError(
                    f"parameter {p} has inconsistent units across "
                    f"matrices: {unit_of[p]} vs {base}")
            unit_of[p] = base
    blocks = []
    row_segs = []
    row0 = 0
    for m in matrices:
        cols = []
        mat = m.matrix
        for p in all_params:
            if p in m.param_names:
                cols.append(mat[:, m.get_slice(1, p)])
            else:
                cols.append(mat.new_zeros((mat.shape[0], 1)))
        blocks.append(torch.cat(cols, dim=1))
        q, qu, _ = m.axis_labels[0][0]
        row_segs.append((q, qu, (row0, row0 + mat.shape[0])))
        row0 += mat.shape[0]
    combined = torch.cat(blocks, dim=0)
    out = PintMatrix(combined, [
        row_segs,
        _param_segments(all_params, [unit_of[p] for p in all_params]),
    ])
    out.param_names = all_params
    return out


def combine_design_matrices_by_param(matrices):
    """Concatenate matrices of the SAME quantity along the parameter
    axis (reference: pint_matrix.py::combine_design_matrices_by_param).
    Duplicate parameter names are an error."""
    q0 = matrices[0].axis_labels[0][0]
    names, units = [], []
    for m in matrices:
        if m.axis_labels[0][0][0] != q0[0]:
            raise ValueError("matrices must share the row quantity")
        for p, u in zip(m.param_names, m.param_units):
            if p in names:
                raise ValueError(f"duplicate parameter {p}")
            names.append(p)
            units.append(u)
    combined = torch.cat([m.matrix for m in matrices], dim=1)
    return DesignMatrix(combined, q0[0], q0[1], names, units)
