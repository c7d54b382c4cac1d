"""Process start to the window's first request (host clock)."""


def read(obs):
    return obs.setup_s
