"""The ways traffic reaches the program, one file a loop, named by a mix's
``loop``: ``benchmark/loops/<loop>.py``.

A loop file's ``drive(upload, forward, keep, run, dev, args, profiler)``
runs the window and returns (t0, units): the window's start and one
record a unit (a frame, or a batch of frames), host ``perf_counter``
seconds: ``due`` (open loop only), ``start`` (upload begins), ``returned``
(the program's call returned), ``done`` (the unit's outputs complete on
the device) and ``frames``. ``upload(i)`` puts unit ``i`` of the pool on
the device, ``forward`` is the program's call, ``keep(i, out)`` offers a
unit's outputs to the comparison. With a profiler, the mix's
``trace_units`` units from ``trace_from`` on run under it, inside the
harness's spans ``bench.sleep`` (waiting for the camera clock),
``bench.upload``, ``bench.forward`` and ``bench.sync`` (waiting for the
device); the loop sets ``run.traced`` and keeps those units' outputs in
``run.traced_out``. The helpers they share are in ``_shared``.
"""
