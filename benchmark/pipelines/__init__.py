"""What a run builds of the program and how it judges the outputs, one file
a pipeline, named by a configuration's ``pipeline`` (``frontend`` where it
names none): ``benchmark/pipelines/<pipeline>.py``. The harness
(:mod:`benchmark.run`) calls four functions of it:

* ``settings()``: the configuration keys, besides the harness's own
  (:data:`benchmark.spec.HARNESS_KEYS`), that the pipeline hands to the
  program; the run refuses a configuration with any other key;
* ``build(cell, dev, factory=None)`` -> (forward, octaves): the program's
  call on one unit of frames on ``dev`` (``factory(program)`` in its
  place where given: the control's and the tests' hook), and the (H, W)
  of each pyramid octave for the rooflines, or None;
* ``to_host(out)`` -> one record a frame of a unit's outputs, on the host;
* ``check(cell, pairs, dev)`` -> (ok, rows, failed, info): the kept
  frames, as (frame, record) pairs, judged against the configuration's
  reference after the window; ``rows`` the numbers compared, (name,
  value, limit); ``failed`` the frames whose answer is missing; ``info``
  numbers the run prints beside them.
"""
