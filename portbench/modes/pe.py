"""Mode `pe`: pairs of reads through the port's PairedAligner on one
card (`submit` takes a list of (mate 1, mate 2) SeqRecord pairs)."""

PAIRED = True


def aligner(data, policy, device, chips):
    from bowtie2_tpu_torch.pipeline.paired import PairedAligner

    if chips != 1:
        raise ValueError("mode pe runs on one card")
    return PairedAligner(data, policy, device=device)


def records(units, names):
    """The port's records of a batch of pairs of reads."""
    from bowtie2_tpu_torch.io.fastx import SeqRecord

    return [(SeqRecord(name=n, seq=a[0], qual=a[1]),
             SeqRecord(name=n, seq=b[0], qual=b[1]))
            for (a, b), n in zip(units, names)]
