"""xlstm-350m [ssm] — alternating sLSTM + mLSTM blocks [arXiv:2405.04517;
unverified].  Fully recurrent (matrix/scalar memories), so the long_500k
decode cell runs: state is O(1) in sequence length.
"""
from repro_torch.configs.base import ArchConfig, XLSTMConfig, register

XLSTM_350M = register(
    ArchConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,  # xLSTM blocks embed their own up/down projections
        vocab_size=50304,
        layer_pattern=("slstm", "mlstm"),
        ffn_on="none",
        xlstm=XLSTMConfig(),
        subquadratic=True,
        source="arXiv:2405.04517",
    )
)
