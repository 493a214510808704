"""The program's half of the flow family ``pwclite`` (the reference's half
is ``reference/flow_pwclite.py``): the weights the serving pool takes as
``flow_params``, read from the checkpoint the CLIs take as
``--flow_model``."""


def program_params(path: str, device):
    from fast_artistic_videos_tpu_torch.flow import estimator

    return estimator.load_params(path, device)
