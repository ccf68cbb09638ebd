"""Host clock around each ``EngramRuntime.step()`` of the window that ran
a decode wave and admitted nothing: all such time over all such steps,
in ms (layer: runtime and engine, ``serving/runtime.py``,
``serving/engine.py``)."""


def read(run):
    t = [s.t1 - s.t0 for s in run.window.steps
         if s.decode and not s.prefills]
    return 1e3 * sum(t) / len(t) if t else None
