"""What a command-line workunit pays outside its work, in s per
workunit: the child's wall on the harness's clock minus the walls of its
run report's phases (whitening, template loop, oracle rescore).  That
holds the interpreter's start and the imports (before the report's
clock), and the CUDA context, library loads, cuFFT plans and the
checkpoint and result writes (inside the report's wall, in no phase)."""


def read(obs):
    gaps = obs.get("startup_s")
    return sum(gaps) / len(gaps) if gaps else None
