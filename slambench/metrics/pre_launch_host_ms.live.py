"""Host milliseconds per frame from entering ``SlamSystem.track`` to the
launch call of its tracking replay (upload, staging, the program's loads),
averaged over the frames that launch one."""

from slambench import program_spans


def read(trace):
    return program_spans.pre_launch_host_ms(trace)
