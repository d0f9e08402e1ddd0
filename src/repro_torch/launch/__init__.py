"""Launchers of the port: the production mesh, serving, training and the
multi-pod dry run.

NOTE: ``dryrun`` owns the default process group while it runs (it creates
a fake one of 256 or 512 ranks and destroys it after), so run it in a
process of its own (``python -m repro_torch.launch.dryrun``), never in one
that has a group, a pytest worker's included, except through
``dryrun.fake_group``, which it closes.
"""
