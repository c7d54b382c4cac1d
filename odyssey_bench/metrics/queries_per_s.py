"""Requests answered inside the window with rows equal to the reference's,
over the window's seconds (host clock)."""


def read(obs):
    done = sum(1 for (req, _, _), ok in zip(obs.records, obs.ok)
               if ok and req.t_done <= obs.t_end)
    return done / obs.seconds
