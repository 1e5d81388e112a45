"""repro_torch.domains — domain implementations for the shared runtime.

    pricing     — derivatives pricing (paper §4): MC paths vs CI accuracy
"""
