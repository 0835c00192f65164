"""Faults planted in the measured program, for the check's own tests and
for the readings that set its limits. Each driver's ``fault(name)`` is a
context manager that breaks the timed path underneath the harness, which
must then report ``correct`` false:

* ``unchanged``: the step returns the model it was given (Adam's
  updates are 0, in the inversion step and in the train step);
* ``half``: the loss leaves out half of the batch (the inversion's
  per-sample losses count the first half twice, the train loss takes the
  mean over the first half);
* ``altered``: an answer altered where it is produced (the first
  sample's inverted model moved by 0.05, about 75 m/s, as the engine
  returns it; the train loss scaled by 1.01).

A cell on one chip has no exchange between chips to leave out. The
inversion driver has three more, each a part of the step that its first
step alone cannot show: ``stale`` (every step replays the first step's
draws), ``b1`` (Adam's first moment rate 0.8 for 0.9) and ``obsgrad``
(the observation loss's gradient doubled, its value kept: the balance of
the two terms' gradients changed); the training driver two more, ``ema``
(the EMA left as it was built: its gate never opens) and ``emadecay``
(the EMA blends with the configured decay from its first blend on, its
warm-up left out).
"""
import contextlib


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.name`` replaced by ``make(obj.name)`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)
