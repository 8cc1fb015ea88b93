"""Host-device synchronisations in one run, counted by torch.cuda's sync
debug mode."""


def read(m):
    return m.syncs_per_run
