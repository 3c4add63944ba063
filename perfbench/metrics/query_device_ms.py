"""Device busy time over the warm queries (the playlist's order and dedup
verdicts on the card), in ms a query."""


def read(view):
    warm, queries = view.counts.get("warm"), view.counts.get("warm_queries")
    if not warm or not queries:
        return None
    busy = view.busy_s(lo=warm[0], hi=warm[1])
    return 1e3 * busy / queries if busy else None
