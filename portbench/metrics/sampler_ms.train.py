"""sampler_ms.train: mean host ms of TripletSampler.sample_batch per step
in the window."""
from portbench.readers import host_mean_ms


def read(run):
    return host_mean_ms(run, "sampler")
