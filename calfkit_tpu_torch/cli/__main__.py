"""``python -m calfkit_tpu_torch.cli`` runs ``ck``."""

from calfkit_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(prog_name="ck")
