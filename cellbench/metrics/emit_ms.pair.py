"""Host time in the native replay of a pair's moves
(``native.bindings.emit_moves``, the benchmark's span) per traced request,
in ms."""


def read(rec):
    calls, seconds = rec.spans.get("emit", (0, 0.0))
    if not calls or not rec.traced["requests"]:
        return None
    return 1e3 * seconds / rec.traced["requests"]
