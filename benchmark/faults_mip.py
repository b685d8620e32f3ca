"""The control and the planted faults that the Mip-Splatting cells'
`correct` has to catch.

Each is a context manager that changes the program under the timed path for
the block's duration and restores it after (faults.patched). Neither the
benchmark's runs nor the program use them: the limits of
checks/capture-train.json were set from their readings on the card (PERF.md),
and benchmark/tests/test_bench_cli.py and tests/test_torch_mip.py see them
caught at a small size on the CPU.

- `control`: the same run without the switch: plain 3DGS, `--mip_splatting`
  taken off the command line (drivers/cli.py reads `CONTROL`).
- `filter_2d_03`: the 2D filter's variance 0.3 (3DGS's dilation) in place
  of 0.1 (`render.project.MIP_FILTER_2D`).
- `no_comp_2d`, `no_comp_3d`: the projected opacity divided back by the 2D
  filter's compensation (sqrt(det / det(+ 0.1)), from the conic) or by the
  3D filter's (from the scales and the filter): the compensation left out.
- `filter_var_not_sqrt`: the 3D filter scaled by 0.2 in place of sqrt(0.2)
  (`render.filter3d.filter_factor`).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.faults import patched

CONTROL = {"control": False}   # a flag the cli driver reads: drop --mip_splatting


@contextlib.contextmanager
def control():
    CONTROL["control"] = True
    try:
        yield
    finally:
        CONTROL["control"] = False


@contextlib.contextmanager
def filter_2d_03():
    from gsplat_tpu_torch.render import project

    with patched(project, "MIP_FILTER_2D", lambda _: 0.3):
        yield


def _comp_2d(conic: torch.Tensor, var: float) -> torch.Tensor:
    """sqrt(det(S - var I) / det(S)), S the 2D covariance the conic inverts."""
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    det = 1.0 / (a * c - b * b)
    A, B, C = c * det, -b * det, a * det
    det0 = (A - var) * (C - var) - B * B
    return torch.sqrt(torch.clamp(det0 / det, min=0.0))


def _comp_3d(g) -> torch.Tensor:
    s2 = torch.exp(g.scaling) ** 2
    f2 = (g.filter_3d ** 2)[:, None]
    return torch.sqrt((s2 / (s2 + f2)).prod(dim=1))


def _opacity_fault(divide):
    @contextlib.contextmanager
    def fault():
        from gsplat_tpu_torch.render import project, render as render_mod

        def make(orig):
            def project_gaussians(g, cam, *a, **k):
                out = orig(g, cam, *a, **k)
                if not g.mip:
                    return out
                d = divide(out, g, project.MIP_FILTER_2D)
                ok = out.visible & (d > 0)
                op = torch.where(ok, out.opacity / torch.where(ok, d, torch.ones_like(d)),
                                 out.opacity)
                return out._replace(opacity=op)
            return project_gaussians

        with patched(render_mod, "project_gaussians", make):
            yield
    return fault


no_comp_2d = _opacity_fault(lambda out, g, var: _comp_2d(out.conic.detach(), var))
no_comp_3d = _opacity_fault(lambda out, g, var: _comp_3d(g).detach())


@contextlib.contextmanager
def filter_var_not_sqrt():
    from gsplat_tpu_torch.render import filter3d

    with patched(filter3d, "filter_factor", lambda _: lambda: filter3d.FILTER_VARIANCE):
        yield


FAULTS = {"filter_2d_03": filter_2d_03, "no_comp_2d": no_comp_2d, "no_comp_3d": no_comp_3d,
          "filter_var_not_sqrt": filter_var_not_sqrt}
