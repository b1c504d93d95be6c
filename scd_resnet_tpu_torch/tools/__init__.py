"""The port's command-line tools, each run as ``python -m
scd_resnet_tpu_torch.tools.<name>``: ``f1_eval`` (detection F1 against
annotation files), ``f1_pipeline`` (slides -> archive -> training ->
live and traced serving -> F1, through the port's CLIs),
``eval_checkpoint`` (a checkpoint's [It] line), ``export_checkpoint``
(a reference-loadable ``.pth``), ``label_tool`` and ``label_server``
(annotation review and editing) and ``loadtest`` (concurrent requests
to the serving daemon). Counterparts of the root ``tools/`` scripts of
the same names.
"""
