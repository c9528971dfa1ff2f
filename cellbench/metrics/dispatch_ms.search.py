"""The search's per-request host steps: the benchmark span ``dispatch``
(around ``seqalign_torch.parallel.search.dispatch``: the query's upload
and the kernel launches) per traced request, in ms."""


def read(rec):
    calls, seconds = rec.spans.get("dispatch", (0, 0.0))
    if not calls or not rec.traced["requests"]:
        return None
    return 1e3 * seconds / rec.traced["requests"]
