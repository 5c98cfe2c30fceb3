"""host_build_s: the host's build of the run's data and graph, in seconds.

Layer: host data (``io.py`` and ``native.py`` reading the rating files,
the ``-testSet`` file, ``data/`` building ``Interactions``,
``GraphRecommender.joint_adj`` building the adjacency on the host and
moving it to the device). Moves ``setup_s``. Read from the benchmark's
clock around ``system.build``: the session's load and split,
``Interactions``, the model and ``prepare_graph``.
"""

NAME = "host_build_s"
UNIT = "s"
LAYER = "host data"
MOVES = "setup_s"


def read(record, summary):
    return record.get("host_build_s")
