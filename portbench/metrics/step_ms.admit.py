"""Host clock around each step of the window that admitted requests
(``Engine._admit``'s prefill groups, and the step's decode wave), over
the thousands of prompt tokens they admitted: ms per 1000 prompt
tokens."""


def read(run):
    steps = [s for s in run.window.steps if s.prefills]
    tokens = sum(s.prompt_tokens for s in steps)
    if not tokens:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / (tokens / 1e3)
