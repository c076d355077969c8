"""``describe_histogram_device_ms.<split>``: device milliseconds a frame of
the operations the program launches inside its ``sift.describe.histogram``
sub-span. Device trace."""

from benchmark.metrics._stage import device_ms


def read(run):
    return device_ms(run, "sift.describe.histogram")
