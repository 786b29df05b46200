"""conv_roofline_32px.bulk: conv_roofline.bulk for the layers whose input
map is 32x32 (layers 0-2 of the paper's network, 83% of its operations):
their least time, for every whole call in the traced window, over the
device time of their kernel launches, in percent.  The launches are
assigned to layers by their order in each call (`portbench.launches`)."""

from portbench import launches


def read(run):
    return launches.group_roofline(run, lambda layer: layer["hw"] == 32)
