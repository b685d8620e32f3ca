"""The control and the planted faults that `correct` has to catch.

Each is a context manager that changes the program under the timed path for
the block's duration and restores it after. Neither the benchmark's runs nor
the program use them: `calibrate.py` reads their numbers on the card at the
cells' sizes, and `tests/test_bench_faults.py` sees `correct` come out false
under each at a small size on the CPU.

- `control`: the program's own lower-precision path, the packed pair table
  (`attr_pack`: colours and opacity rounded to bfloat16 in the compositors'
  input), switched on through `render.raster.PACK_DEFAULT`.
- train cells: `unchanged_state` (the step returns its parameters and
  optimizer state unchanged), `half_batch` (the loss over the top half of
  the image's rows, the mean taken over them), `altered_answer` (the
  rendered image raised by 0.01 on its first 32x32 pixels where render
  produces it).
- view cells: `stale_frame` (every reply carries the first frame's bytes),
  `half_frame` (the bottom half of each reply's rows zero), `altered_byte`
  (one byte of each reply flipped).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(module, name: str, make):
    """module.name replaced by make(original) inside the block."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def control():
    from gsplat_tpu_torch.render import raster

    with patched(raster, "PACK_DEFAULT", lambda _: True):
        yield


@contextlib.contextmanager
def unchanged_state():
    from gsplat_tpu_torch.train import loop

    with patched(loop, "adam_update", lambda _: lambda p, g, s, lrs: (p, s)):
        yield


@contextlib.contextmanager
def half_batch():
    from gsplat_tpu_torch.train import loop

    def make(orig):
        def loss(pred, gt, lam=0.2):
            h = pred.shape[0] // 2
            return orig(pred[:h], gt[:h], lam)
        return loss

    with patched(loop, "photometric_loss", make):
        yield


@contextlib.contextmanager
def altered_answer():
    from gsplat_tpu_torch.render import render as render_mod
    from gsplat_tpu_torch.train import loop

    def make(orig):
        def render(*a, **k):
            out = orig(*a, **k)
            bump = out.image.new_zeros(out.image.shape)
            bump[:32, :32] = 0.01
            return out._replace(image=out.image + bump)
        return render

    with patched(loop, "render", make), patched(render_mod, "render", make):
        yield


def _bytes_fault(edit):
    @contextlib.contextmanager
    def fault():
        from gsplat_tpu_torch import network_gui

        def make(orig):
            state = {}

            def image_to_bytes(image):
                return edit(bytearray(orig(image)), state)
            return image_to_bytes

        with patched(network_gui, "image_to_bytes", make):
            yield
    return fault


def _stale(b, state):
    return state.setdefault("first", bytes(b))


def _half(b, state):
    b[len(b) // 2:] = bytes(len(b) - len(b) // 2)
    return bytes(b)


def _flip(b, state):
    b[0] ^= 0x80
    return bytes(b)


stale_frame = _bytes_fault(_stale)
half_frame = _bytes_fault(_half)
altered_byte = _bytes_fault(_flip)

TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch,
         "altered_answer": altered_answer}
VIEW = {"stale_frame": stale_frame, "half_frame": half_frame, "altered_byte": altered_byte}
