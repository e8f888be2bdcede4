"""Share of the host-clock time of the calls into the serving artifact
spent outside its graph replays on the card: 1 - (CUDA-event time around
each replay) / (host time of each call), summed over the untraced calls
(the copies in and out, the wrapper and the wait). One reader for every
group that calls the artifact: ``outside_share.detect``."""

LAYER = "serving artifact"
UNIT = "%"


def read(rec):
    return rec.get("outside_share")
