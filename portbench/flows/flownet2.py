"""The program's half of the flow family ``flownet2`` (the reference's half
is ``reference/flow_flownet2.py``): the weights the serving pool takes as
``flow_params``, read from the checkpoint the CLIs take as
``--flow_model``. The program picks FlowNet 2.0 by the checkpoint's keys
(``flow.family``)."""


def program_params(path: str, device):
    from fast_artistic_videos_tpu_torch.flow import estimator

    return estimator.load_params(path, device)
