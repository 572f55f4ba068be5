"""The hand-written CUDA kernels' wrappers (one module a kernel) and their
registry."""


def kernel_wrappers() -> dict:
    """The hand-written kernels' wrappers by name; each counts its launches
    in ``.launches``."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda import (
        channelizer_kernel, ddc_kernel, fir_kernel, psd_kernel, select_kernel, vote_kernel)

    return {
        "psd_frames_int8": psd_kernel.psd_frames_int8,
        "fused_selection": select_kernel.fused_selection,
        "history_vote": vote_kernel.history_vote,
        "stage_apply_fir": fir_kernel.stage_apply_fir,
        "analysis_bank": channelizer_kernel.analysis_bank,
        "modtap_stage1": ddc_kernel.modtap_stage1,
    }
