"""Device time of the window's host-to-device copies (the batch driver's
staged uploads), over the songs yielded in it, in ms a song."""


def read(view):
    songs = view.counts.get("songs")
    busy = view.busy_s(lambda name: name.startswith("Memcpy HtoD"))
    if not songs or not busy:
        return None
    return 1e3 * busy / songs
